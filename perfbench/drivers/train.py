"""Training steps back to back: ``train/step.py::make_train_step`` on a
``TrainState`` at the mix's global batch, from a pool of batches already
on the card, with no host read between steps.  With ``world`` > 1 the run
starts that many ranks itself (NCCL, one card each, ``parallel.mesh``:
synced BN, summed gradients), each holding its rows of every global
batch; rank 0 prints the line.

Set-up builds the one state the window uses, drives it through three
steps on the pool's first three batches (the first builds the kernels),
and times the last two to fix the window's step count, so every rank runs
the same steps.  The rate is the global frames of all the window's steps
over the window's time, which ends with a synchronise after the last.

``correct``: the float32 reference (``perfbench/reference``) follows the
first three steps on the global batches, from the same weights, with the
program's dropout masks (regenerated from its generator's state at each
draw, recorded in those steps), by plain Adam: ``loss_gap``, the worst of
the three losses' relative gaps; ``grad_gap``, the median leaf's gap of
first-gradient norms (the program's from Adam's first moment after step
1) against that leaf's or the median leaf's reference norm, whichever is
larger (the worst leaf swings from seed to seed with bf16 rounding in a
few small BN leaves); ``update_gap``, the worst leaf's gap of the
parameters' change over the three steps.  Leaves whose reference gradient
is under a thousandth of the median leaf's are not counted.
"""
from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench import scenes, spec, stats, tracing
from perfbench.drivers import common

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, world: int) -> List[subprocess.Popen]:
    port = args.port or _free_port()
    args.port = port
    here = os.path.join(spec.HERE, "run.py")
    procs = []
    for r in range(1, world):
        procs.append(subprocess.Popen(
            [sys.executable, here, "--workload", args.workload, "--seed",
             str(args.seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace), "--rank", str(r), "--port", str(port)],
            stdout=subprocess.DEVNULL))
    return procs


class DropoutRecord:
    """Records, at each dropout draw of the first steps, the generator's
    state, the shape and the rate: the reference draws the same masks."""

    def __init__(self):
        self.draws: List = []
        self.on = True
        self._undo = None

    def install(self):
        import pvn3d_tpu_torch.models.layers as layers
        orig = layers.dropout

        def dropout(x, rate, training, generator=None):
            if self.on and training and rate:
                self.draws.append((generator.get_state(), tuple(x.shape),
                                   rate))
            return orig(x, rate, training, generator)
        bound = [(m, a) for m in list(sys.modules.values())
                 if getattr(m, "__name__", "").split(".")[0]
                 == tracing.PACKAGE
                 for a, v in list(vars(m).items()) if v is orig]
        for m, a in bound:
            setattr(m, a, dropout)
        self._undo = lambda: [setattr(m, a, orig) for m, a in bound]

    def remove(self):
        if self._undo:
            self._undo()


def reference_masks(draws_by_rank, device, batch: int):
    """Per step, the image branch's masks on the global batch of ``batch``
    rows: each rank's draws redone from their generator states, ranks'
    rows concatenated; rows no draw covered (a program that left rows
    out) keep every element."""
    per_step = len(draws_by_rank[0]) // 3
    steps = []
    for s in range(3):
        masks = []
        for d in range(per_step):
            rows = []
            for draws in draws_by_rank:
                state, shape, rate = draws[s * per_step + d]
                g = torch.Generator(device=device)
                g.set_state(state)
                rows.append(torch.rand(shape, device=device, generator=g)
                            < 1.0 - rate)
            mask = torch.cat(rows).float()
            if mask.shape[0] < batch:
                mask = torch.cat([mask, mask.new_ones(
                    (batch - mask.shape[0],) + mask.shape[1:])])
            masks.append(mask)
        steps.append(masks)
    return steps


def _cyclic_lr(step: int, t: Dict) -> float:
    """The reference's cyclic learning rate (warmup_scheduler/
    scheduler.py:255-263, triangular)."""
    it, ss = float(step), float(t["lr_step_size"])
    cycle = (1.0 + it / (2.0 * ss)) // 1
    amp = max(0.0, 1.0 - abs(it / ss - 2.0 * cycle + 1.0))
    return t["base_lr"] + (t["max_lr"] - t["base_lr"]) * amp


def reference_steps(config: Dict, sd, names: List[str], batches, masks,
                    low_precision: bool = False):
    """Three float32 steps of the reference: losses, the first gradient's
    leaf norms, the three steps' change's leaf norms."""
    from perfbench.reference.model import Reference
    t = config["program"]["train"]
    w = t["loss_weights"]
    params = {k: sd[k].detach().clone().float().requires_grad_(True)
              for k in names}
    state = dict(sd)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, g1 = [], None
    for step in range(3):
        state.update(params)
        ref = Reference(config["program"]["model"], state, train=True,
                        low_precision=low_precision, checkpoint=True)
        b = batches[step]
        out = ref.forward(b["pointcloud"], b["rgb"], b["choose"],
                          masks[step])
        labels = b["labels"].long()
        logp = F.log_softmax(out["seg_logits"], -1)
        logpt = logp.gather(-1, labels[..., None])[..., 0]
        seg = (-((1.0 - logpt.detach().exp()) ** t["focal_gamma"])
               * logpt).mean()
        fg = (labels > 0).float()
        offs = []
        for key, tgt in (("kp_offsets", "kp_targ_ofst"),
                         ("ctr_offsets", "ctr_targ_ofst")):
            diff = (out[key] - b[tgt].permute(0, 2, 1, 3)).abs() \
                * fg[:, None, :, None]
            offs.append((diff.sum((2, 3)) / (fg.sum(1)[:, None] + 1e-3))
                        .sum())
        loss = w[0] * seg + w[1] * offs[0] + w[2] * offs[1]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), torch.autograd.grad(
                     loss, list(params.values()), allow_unused=True))]
        losses.append(float(loss.detach()))
        lr = _cyclic_lr(step, t)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = g + t["weight_decay"] * p
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                mh = m[k] / (1 - BETA1 ** (step + 1))
                vh = v[k] / (1 - BETA2 ** (step + 1))
                p.sub_(lr * mh / (vh.sqrt() + EPS))
            if step == 0:
                g1 = {k: float(g.norm()) for k, g in zip(params, grads)}
        del out, loss, grads
    change = {k: float((params[k].detach() - sd[k]).norm()) for k in names}
    return losses, g1, change


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              counted: List[str]) -> Dict[str, float]:
    """Each counted leaf's gap of norms, against that leaf's or the
    median leaf's reference norm, whichever is larger."""
    med = statistics.median(ref[k] for k in counted)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in counted}


def counted_leaves(grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    med = statistics.median(grad.values())
    return [k for k in grad if grad[k] >= 1e-3 * med]


def compare(program, reference) -> Dict[str, float]:
    """The numbers from the program's and the reference's (losses,
    first-gradient leaf norms, change leaf norms): the worst step's loss
    gap, the median leaf's first-gradient gap, the worst leaf's change
    gap."""
    lp, gp, cp = program
    lr, gr, cr = reference
    counted = counted_leaves(gr)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "grad_gap": statistics.median(
                leaf_gaps(gp, gr, counted).values()),
            "update_gap": max(leaf_gaps(cp, cr, counted).values())}


class Trainer:
    """The port's train step on the seed's weights and batch pool."""

    def __init__(self, cell: Dict, args, device, mesh=None):
        from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
        from pvn3d_tpu_torch.train.step import make_train_step
        self.cell, self.args, self.device, self.mesh = cell, args, device, mesh
        self.config = cell["config"]
        self.mix = cell["traffic"]
        cfg = spec.program_config(self.config)
        model, self.sd = common.port_model(cfg, args.seed, device)
        self.names = [k for k, _ in model.named_parameters()]
        self.state = TrainState(0, model.train(), make_optimizer(cfg, model))
        self.world = 1 if mesh is None else mesh.dp
        self.pool = scenes.train_batches(args.seed, self.mix, self.config,
                                         device)
        rank = 0 if mesh is None else mesh.rank
        b = self.mix["batch"] // self.world
        self.local = [{k: v[rank * b:(rank + 1) * b] for k, v in p.items()}
                      for p in self.pool]
        self.spans = tracing.Spans()
        self.step_fn = make_train_step(cfg, device, mesh)

    def step(self, i: int):
        return self.step_fn(self.state, self.local[i % len(self.local)],
                            seed=self.args.seed)

    def first_steps(self):
        """Steps 1-3 on batches 0-2: losses, first-gradient and change
        leaf norms, and the seconds of steps 2 and 3."""
        opt = self.state.optimizer
        params = dict(self.state.model.named_parameters())
        losses, secs, g1 = [], [], None
        for i in range(3):
            common.sync(self.device)
            t0 = time.perf_counter()
            _, metrics = self.step(i)
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t0)
            if i == 0:
                # A leaf the loss does not reach gets no gradient, and
                # Adam no state.
                g1 = {k: float(opt.state[p]["exp_avg"].norm()) / (1 - BETA1)
                      if p in opt.state else 0.0 for k, p in params.items()}
        change = {k: float((p.detach() - self.sd[k]).norm())
                  for k, p in params.items()}
        return (losses, g1, change), secs[1:]

    def trace_spans(self):
        self.spans.module(self.state.model, "", "forward")
        common.wrap_kernels(self.spans)

    def free_program(self):
        self.spans.remove()
        self.state = self.step_fn = self.local = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: Dict, args, t_start: float, device=None) -> Dict:
    import torch.distributed as dist
    world = cell["traffic"]["world"]
    procs, mesh = [], None
    if world > 1:
        from pvn3d_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh)
        if args.rank == 0:
            procs = _spawn_ranks(args, world)
        os.environ["LOCAL_RANK"] = str(args.rank)
        initialize_distributed(f"tcp://localhost:{args.port}", world,
                               args.rank)
        mesh = make_mesh()
        device = mesh.device
    device = device or torch.device("cuda")
    try:
        return _run(cell, args, t_start, device, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            p.wait()


def _gather(mesh, obj):
    import torch.distributed as dist
    if mesh is None:
        return [obj]
    out = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _run(cell, args, t_start, device, mesh) -> Dict:
    import torch.distributed as dist
    torch.manual_seed(args.seed)
    common.setup_log(t_start, "imports and process group")
    tr = Trainer(cell, args, device, mesh)
    common.setup_log(t_start, "weights, batches and state")
    rec = DropoutRecord()
    rec.install()
    program, secs = tr.first_steps()
    rec.on = False
    rec.remove()
    n_steps = max(1, round(args.seconds / max(secs)))
    if mesh is not None:
        t = torch.tensor([n_steps], device=device)
        dist.broadcast(t, 0, group=mesh.group)
        n_steps = int(t.item())
    traced = bool(args.trace)
    if traced:
        tr.trace_spans()
        n_steps = cell["traffic"]["traced"]
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    common.setup_log(t_start, "three steps")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if traced:
        def units(span):
            for i in range(n_steps):
                with span():
                    tr.step(3 + i)
        prof = common.profile(units, device)
    else:
        for i in range(n_steps):
            tr.step(3 + i)
        common.sync(device)
    window = time.perf_counter() - t0
    frames = n_steps * cell["traffic"]["batch"]
    peak = max(_gather(mesh, common.peak_bytes(device)))
    out = {"attempted": n_steps, "failed": 0,
           "device": common.device_record(device, tr.world, peak)}
    if traced:
        common.traced_result(out, cell, prof, tr.spans,
                             cell["traffic"]["batch"], tr.world)
        del prof
    else:
        out["metrics"] = {"train_frames_per_s": stats.rate(frames, window),
                          "setup_s": setup_s}
    draws = _gather(mesh, rec.draws)
    tr.free_program()
    if mesh is not None and mesh.rank != 0:
        return None
    masks = reference_masks(draws, device, cell["traffic"]["batch"])
    ref = reference_steps(tr.config, tr.sd, tr.names, tr.pool, masks)
    out["checks"], out["correct"] = common.checks(compare(program, ref),
                                                  cell["limits"])
    return out
