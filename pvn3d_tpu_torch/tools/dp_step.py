"""Time the data-parallel train step beside the plain step on the cards.

    torchrun --nproc_per_node=4 -m pvn3d_tpu_torch.tools.dp_step \\
        [--batch 4] [--reps 3] [--seed 0] [--out FILE]

Every rank builds the full-width YCB model (``Config.ycb()``, random
weights from ``--seed``, broadcast from rank 0) and puts its ``--batch``
rows of a synthetic global batch on its card before anything is timed:
no loader and no host decode stand in the way.  It then runs, in turns
from the same weights, the mesh's train step (synced BatchNorm, the
summed gradient all-reduce, the global metrics) and the plain step on
the same rows: one warm-up of each, then ``--reps`` of each, every one
timed on the host clock to its end (the card synchronised).  Last, one
CUDA-only ``torch.profiler`` trace of each step: the device time summed
over kernels and copies, and the NCCL kernels' count and device time
(an NCCL kernel's time includes its wait for the slowest rank).

Rank 0 prints one ``[dp_step]`` JSON line with every rank's record and
writes it to ``--out``.  Without torchrun's environment it runs in one
process, where the two steps are the same step.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch


def cuda_trace(fn) -> dict:
    """One call of ``fn`` in a ``torch.profiler`` trace of CUDA activity:
    the device records' summed time, their count, and the NCCL kernels'
    count and summed time, in ms."""
    from torch._C._autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    nccl = [e for e in dev if "nccl" in e.name().lower()]
    return {"device_ms": sum(e.duration_ns() for e in dev) / 1e6,
            "records": len(dev), "nccl_kernels": len(nccl),
            "nccl_ms": sum(e.duration_ns() for e in nccl) / 1e6}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=4,
                   help="frames per rank (the global batch is world times)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                          replicated, shard_batch)
    from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
    from pvn3d_tpu_torch.train.step import make_train_step
    from pvn3d_tpu_torch.utils.weights import build_model

    initialize_distributed()
    mesh = make_mesh()
    cfg = Config.ycb()
    model = build_model(cfg.model, args.seed).to(mesh.device).train()
    replicated(mesh, model)
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = shard_batch(mesh, synthetic_batch(
        cfg, batch_size=args.batch * mesh.dp, seed=args.seed))
    steps = {"plain": make_train_step(cfg, mesh.device),
             "mesh": make_train_step(cfg, mesh.device, mesh)}

    def run(name):
        model.load_state_dict(sd0)
        state = TrainState(0, model, make_optimizer(cfg, model))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = steps[name](state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(metrics["loss"])

    for name in steps:                                      # warm-up
        run(name)
    ms = {name: [] for name in steps}
    loss = {}
    for i in range(args.reps):
        for name in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
            t, loss[name] = run(name)
            ms[name].append(t)
    trace = {}
    for name in steps:
        model.load_state_dict(sd0)
        state = TrainState(0, model, make_optimizer(cfg, model))
        trace[name] = cuda_trace(lambda: steps[name](state, batch))
    rec = {"rank": mesh.rank, "card": _card(), "ms": ms, "loss": loss,
           "trace": trace,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    recs = [rec]
    if mesh.group is not None:
        recs = [None] * mesh.dp
        dist.all_gather_object(recs, rec, group=mesh.group)
    out = {"world": mesh.dp, "batch_per_rank": args.batch,
           "config": "Config.ycb()", "torch": torch.__version__,
           "cuda": torch.version.cuda, "ranks": recs}
    if mesh.rank == 0:
        print("[dp_step] " + json.dumps(out), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
