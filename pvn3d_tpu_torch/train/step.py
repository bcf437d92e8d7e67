"""The train and eval steps.

Port of the JAX package's ``train/step.py``.  One train step = forward +
focal / offset losses (weights [2, 1, 1], reference:
train_ycb_pvn3d.py:172-189) + gradients + Adam update + BN statistics
update.  The JAX step is one jitted function of an immutable state; this
one runs eagerly and updates ``state`` in place.

Under a data-parallel mesh (``parallel/mesh.py``) each rank runs its rows
of the global batch, the BatchNorms take global statistics, and the
gradients are summed over the ranks after the backward, which is what
GSPMD makes of the JAX step.  ``cfg.train.remat`` recomputes the forward
in the backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.models.layers import BatchNorm
from pvn3d_tpu_torch.models.losses import (focal_loss, offset_l1_loss,
                                           seg_accuracy)
from pvn3d_tpu_torch.parallel.mesh import Mesh, all_reduce_gradients
from pvn3d_tpu_torch.train.schedule import bn_momentum_at, lr_schedule
from pvn3d_tpu_torch.train.state import TrainState
from pvn3d_tpu_torch.utils.device import disable_tf32, resolve_device
from pvn3d_tpu_torch.utils.profiling import annotate

_INPUTS = ("pointcloud", "rgb", "choose")
_TARGETS = ("labels", "kp_targ_ofst", "ctr_targ_ofst")
# The loss components: the offset terms sum over frames, the rest are
# means (reference: train_ycb_pvn3d.py:176-181).
_SUMMED = ("loss_kp", "loss_ctr")
_MEANS = ("loss_seg", "acc_rgbd")


def compute_losses(cfg: Config, outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weighted total + components (train_ycb_pvn3d.py:172-189)."""
    labels = batch["labels"]
    seg = focal_loss(outputs["seg_logits"], labels,
                     gamma=cfg.train.focal_gamma)
    kp = offset_l1_loss(outputs["kp_offsets"], batch["kp_targ_ofst"], labels)
    ctr = offset_l1_loss(outputs["ctr_offsets"], batch["ctr_targ_ofst"],
                         labels)
    w = cfg.train.loss_weights
    return {
        "loss": w[0] * seg + w[1] * kp + w[2] * ctr, "loss_seg": seg,
        "loss_kp": kp, "loss_ctr": ctr,
        "acc_rgbd": seg_accuracy(outputs["seg_logits"], labels),
    }


def global_metrics(cfg: Config, mesh: Mesh, metrics: Dict, count=1
                   ) -> Dict[str, torch.Tensor]:
    """The loss components of every rank's rows put together with the
    global batch's meaning, the same on every rank.  ``metrics`` holds a
    rank's sums over ``count`` batches of its rows (one step's: 1; a rank
    with none passes an empty dict and 0); over
    all ranks' C batches, the means are the sums over C and the offset
    terms (sums over frames, and a global batch holds ``dp`` ranks'
    rows) the sums times dp over C; the total is rebuilt.  One
    all-reduce."""
    keys = _MEANS + _SUMMED
    zero = torch.zeros((), device=mesh.device)
    vec = torch.stack([metrics.get(k, zero).float() for k in keys]
                      + [zero + count])
    torch.distributed.all_reduce(vec, group=mesh.group)
    c = vec[-1]
    out = {k: v / c if k in _MEANS else v * mesh.dp / c
           for k, v in zip(keys, vec.unbind())}
    w = cfg.train.loss_weights
    out["loss"] = (w[0] * out["loss_seg"] + w[1] * out["loss_kp"]
                   + w[2] * out["loss_ctr"])
    return out


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's fields of ``batch`` (numpy arrays or tensors) as tensors
    on ``device``; a copy from host memory waits for the stream."""
    with annotate("pvn3d.read.batch_upload"):
        return {k: torch.as_tensor(batch[k], device=device)
                for k in _INPUTS + _TARGETS if k in batch}


def dropout_seed(seed: int, step: int, micro: int) -> int:
    """One generator seed per (run seed, step, micro-batch): the
    counterpart of the JAX step's ``fold_in`` chain.  Under a mesh the
    micro-batch index counts over the ranks (``rank * accum + i``), so
    ranks draw their own masks and rank 0 draws one process's."""
    return ((seed * 1_000_003 + step) * 1_000_003 + micro) % (2 ** 63)


# The outputs the "dots" policy keeps: convolutions and matmuls, JAX's
# dot_general and conv_general_dilated.
_DOT_OPS = frozenset((torch.ops.aten.convolution.default,
                      torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default))


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy "dots": save every conv and matmul
    output, recompute the rest (BN, activations, gathers, resizes)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: str):
    """The selective-checkpoint policy of a ``TrainConfig.remat_policy``:
    None for "full" (save nothing), ``dots_policy`` for "dots"."""
    if name == "full":
        return None
    if name == "dots":
        return dots_policy
    raise ValueError(f"unknown remat_policy {name!r} (full|dots)")


@contextlib.contextmanager
def _recompute(inner, bns, generator: torch.Generator, state: torch.Tensor):
    """The recomputed forward's context: the policy's own, the BNs'
    running statistics held (the first forward moved them), and the
    dropout generator back at its state before that forward (checkpoint
    replays only the default generators)."""
    with inner:
        generator.set_state(state)
        for bn in bns:
            bn.update_running = False
        try:
            yield
        finally:
            for bn in bns:
                bn.update_running = True


def _rematerialised(model: torch.nn.Module, policy,
                    generator: torch.Generator, *args):
    """``model(*args)`` under ``torch.utils.checkpoint``: only the inputs
    (and, with a policy, what it saves) are kept; the backward recomputes
    the rest."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    state = generator.get_state()

    def context_fn():
        fwd, rec = (create_selective_checkpoint_contexts(policy)
                    if policy is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _recompute(rec, bns, generator, state)
    return checkpoint(model, *args, use_reentrant=False,
                      context_fn=context_fn)


def make_train_step(cfg: Config, device: str | torch.device = "cuda",
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict, int],
                                  Tuple[TrainState, Dict]]:
    """``train_step(state, batch, seed=cfg.train.seed) -> (state,
    metrics)``: ``state`` is updated in place and returned; the metrics are
    detached scalars on the device (no host read) plus the step's
    ``bn_momentum``.

    With ``cfg.train.grad_accum`` > 1 the batch is cut into that many
    equal micro-batches run in sequence: each micro loss scales only its
    seg term by 1/accum (the seg loss is a mean over points, the offset
    losses are sums over frames), the gradients are summed, BN statistics
    move once per micro-batch, and the optimizer applies once.

    With a ``mesh`` whose group exists, ``batch`` is this rank's rows of
    the global batch and every rank calls the step.  The BNs normalise by
    the global statistics; the seg term scales by 1/(accum * world) as
    well; after the last backward the gradients are summed over the ranks,
    so they equal one process's gradient of the global batch; the metrics
    are the global batch's on every rank.  ``state.model`` stays the bare
    module (checkpoint keys unchanged).  With ``cfg.train.remat`` the
    forward is rematerialised under ``cfg.train.remat_policy``.
    """
    dev = resolve_device(device)
    disable_tf32()
    accum = max(int(cfg.train.grad_accum), 1)
    sched = lr_schedule(cfg.train)
    w = cfg.train.loss_weights
    generator = torch.Generator(device=dev)
    dp_group = None if mesh is None else mesh.group
    world, rank = (1, 0) if dp_group is None else (mesh.dp, mesh.rank)
    policy = remat_policy(cfg.train.remat_policy) if cfg.train.remat \
        else None

    def forward(model, micro, bn_m):
        args = (micro["pointcloud"], micro["rgb"], micro["choose"], bn_m,
                generator)
        if cfg.train.remat:
            return _rematerialised(model, policy, generator, *args)
        return model(*args)

    calls = itertools.count()

    def train_step(state: TrainState, batch: Dict, seed: int = cfg.train.seed):
        with annotate("pvn3d.step", next(calls)):
            return _train_step(state, batch, seed)

    def _train_step(state: TrainState, batch: Dict, seed: int):
        batch = to_device(batch, dev)
        b = batch["pointcloud"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum "
                             f"{accum}")
        model = state.model
        if not model.training:
            model.train()
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = dp_group
        bn_m = bn_momentum_at(state.step, cfg.train)
        state.optimizer.zero_grad(set_to_none=True)
        micro_metrics = []
        mb = b // accum
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            generator.manual_seed(dropout_seed(seed, state.step,
                                               rank * accum + i))
            with annotate("pvn3d.forward"):
                outputs = forward(model, micro, bn_m)
            m = compute_losses(cfg, outputs, micro)
            loss = (w[0] / (accum * world) * m["loss_seg"]
                    + w[1] * m["loss_kp"] + w[2] * m["loss_ctr"])
            with annotate("pvn3d.backward"):
                loss.backward()
            micro_metrics.append({k: v.detach() for k, v in m.items()})
        if accum == 1:
            metrics = micro_metrics[0]
        else:
            # Full-batch meaning: means stay means, the summed offset
            # terms sum, the total is put together again.
            stack = {k: torch.stack([m[k] for m in micro_metrics])
                     for k in micro_metrics[0]}
            metrics = {"loss_seg": stack["loss_seg"].mean(),
                       "loss_kp": stack["loss_kp"].sum(),
                       "loss_ctr": stack["loss_ctr"].sum(),
                       "acc_rgbd": stack["acc_rgbd"].mean()}
            metrics["loss"] = (w[0] * metrics["loss_seg"]
                               + w[1] * metrics["loss_kp"]
                               + w[2] * metrics["loss_ctr"])
        if dp_group is not None:
            all_reduce_gradients(mesh, model.parameters())
            metrics = global_metrics(cfg, mesh, metrics)
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
        with annotate("pvn3d.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, dict(metrics, bn_momentum=bn_m)

    return train_step


def make_eval_step(cfg: Config, device: str | torch.device = "cuda"):
    """``eval_step(state, batch) -> (outputs, metrics)``: forward + losses
    with running BN statistics and no dropout, no update (reference:
    Trainer.eval_epoch, train_ycb_pvn3d.py:261-290).  The model is put
    back into the mode it was in."""
    dev = resolve_device(device)
    disable_tf32()

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        batch = to_device(batch, dev)
        model = state.model
        was_training = model.training
        model.eval()
        try:
            outputs = model(batch["pointcloud"], batch["rgb"],
                            batch["choose"])
        finally:
            model.train(was_training)
        return outputs, compute_losses(cfg, outputs, batch)

    return eval_step
