"""The train and eval steps.

Port of the JAX package's ``train/step.py``.  One train step = forward +
focal / offset losses (weights [2, 1, 1], reference:
train_ycb_pvn3d.py:172-189) + gradients + Adam update + BN statistics
update.  The JAX step is one jitted function of an immutable state; this
one runs eagerly and updates ``state`` in place.  ``cfg.train.remat``
(recomputing the forward in the backward) has no counterpart yet and
raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.models.losses import (focal_loss, offset_l1_loss,
                                           seg_accuracy)
from pvn3d_tpu_torch.train.schedule import bn_momentum_at, lr_schedule
from pvn3d_tpu_torch.train.state import TrainState
from pvn3d_tpu_torch.utils.device import disable_tf32, resolve_device

_INPUTS = ("pointcloud", "rgb", "choose")
_TARGETS = ("labels", "kp_targ_ofst", "ctr_targ_ofst")


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


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's fields of ``batch`` (numpy arrays or tensors) as tensors
    on ``device``."""
    return {k: torch.as_tensor(batch[k], device=device)
            for k in _INPUTS + _TARGETS if k in batch}


def dropout_seed(seed: int, step: int, micro: int) -> int:
    """One generator seed per (run seed, step, micro-batch): the
    counterpart of the JAX step's ``fold_in`` chain."""
    return ((seed * 1_000_003 + step) * 1_000_003 + micro) % (2 ** 63)


def make_train_step(cfg: Config, device: str | torch.device = "cuda"
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
    """
    if cfg.train.remat:
        raise NotImplementedError(
            "cfg.train.remat has no counterpart in the port yet: a "
            "recomputed forward would update the BN running statistics "
            "twice")
    dev = resolve_device(device)
    disable_tf32()
    accum = max(int(cfg.train.grad_accum), 1)
    sched = lr_schedule(cfg.train)
    w = cfg.train.loss_weights
    generator = torch.Generator(device=dev)

    def train_step(state: TrainState, batch: Dict, seed: int = cfg.train.seed):
        batch = to_device(batch, dev)
        b = batch["pointcloud"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum "
                             f"{accum}")
        model = state.model
        if not model.training:
            model.train()
        bn_m = bn_momentum_at(state.step, cfg.train)
        state.optimizer.zero_grad(set_to_none=True)
        micro_metrics = []
        mb = b // accum
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            generator.manual_seed(dropout_seed(seed, state.step, i))
            outputs = model(micro["pointcloud"], micro["rgb"],
                            micro["choose"], bn_m, generator)
            m = compute_losses(cfg, outputs, micro)
            loss = (w[0] / accum * m["loss_seg"] + w[1] * m["loss_kp"]
                    + w[2] * m["loss_ctr"])
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
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
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
