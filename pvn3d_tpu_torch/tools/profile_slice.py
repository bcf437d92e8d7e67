"""Where a serving request's, or a training step's, time goes on the card.

    python3 -m pvn3d_tpu_torch.tools.profile_slice [--requests 3]
    python3 -m pvn3d_tpu_torch.tools.profile_slice --train

Runs the full-width ``Config.ycb()`` serving path (seeded random weights,
``synthetic_batch`` frames) on CUDA and prints:

* each stage alone, CUDA-event medians: image branch, point branch,
  fusion + heads, votes -> poses;
* a ``torch.profiler`` trace of ``--requests`` requests: device time by
  kernel (top 25), the four ported kernels' share, and the device's busy
  share of the wall time.

With ``--train`` it runs the full-width training path instead
(``create_train_state`` -> ``make_train_step``, bf16, batch 4,
``grad_accum`` 1) and prints the step's stages alone (forward, loss,
backward, optimizer; CUDA-event medians), the whole step by the host
clock, peak memory, and the same trace over 2 steps.

Needs a card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import re
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType


def _time_ms(fn, trials: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


_TRAIN_BATCH = 4
# Substrings of the ported kernels' names: K3 backward is five kernels,
# three_interp_bwd_{rank,cols,rows,fill,sum}.
_OURS = ("fps_kernel", "ball_query_kernel", "three_interp_kernel",
         "three_interp_bwd_", "winner_kernel")


def _trace(fn, n: int, unit: str) -> None:
    """Run ``fn(i)`` n times under ``torch.profiler`` and print the
    device's busy share of the wall time, the ported kernels' time (each
    by name) and the top 25 device entries."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side entries only (kernels, copies): the launching CPU ops
    # also carry their kernels' time and would count it twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = [e for e in events if any(o in e.key for o in _OURS)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3
    print(f"[trace] {n} {unit}s: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"ported kernels {ours_ms:.2f} ms", flush=True)
    for e in ours:
        name = re.search(r"\w*(?:%s)\w*" % "|".join(_OURS), e.key).group(0)
        print(f"[trace] ported {name}: "
              f"{e.self_device_time_total / 1e3 / n:.4f} ms/{unit} "
              f"x{e.count / n:g}", flush=True)
    for e in events[:25]:
        print(f"[trace] {e.self_device_time_total / 1e3 / n:9.3f}"
              f" ms/{unit}  x{e.count // n:<5d} {e.key[:90]}", flush=True)


def _profile_train(args) -> int:
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.train.schedule import bn_momentum_at
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.train.step import (compute_losses, make_train_step,
                                            to_device)

    cfg = Config.ycb()
    dev = torch.device("cuda")
    state = create_train_state(cfg, args.seed)
    step = make_train_step(cfg)
    batch = to_device(synthetic_batch(cfg, batch_size=_TRAIN_BATCH,
                                      seed=args.seed), dev)
    model, opt = state.model, state.optimizer
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    # The stages of one step, each timed alone on the step's own tensors.
    bn_m = bn_momentum_at(state.step, cfg.train)
    held = {}

    def forward():
        held["out"] = model(batch["pointcloud"], batch["rgb"],
                            batch["choose"], bn_m)

    def loss():
        held["loss"] = compute_losses(cfg, held["out"], batch)["loss"]

    def backward():
        opt.zero_grad(set_to_none=True)
        held["loss"].backward(retain_graph=True)

    for name, fn in (("forward (train mode, batch statistics)", forward),
                     ("loss (focal + 2 offset L1)", loss),
                     ("backward", backward),
                     ("optimizer (fused Adam)", opt.step)):
        print(f"[stage] {name}: {_time_ms(fn):.3f} ms", flush=True)
    held.clear()
    opt.zero_grad(set_to_none=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[stage] whole step (make_train_step, batch {_TRAIN_BATCH}), host "
          f"clock: median {statistics.median(times):.3f} ms of "
          + ", ".join(f"{t:.1f}" for t in times)
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    _trace(lambda i: step(state, batch), 2, "step")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train", action="store_true",
                        help="profile the training step, not serving")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", flush=True)
        return 1
    if args.train:
        return _profile_train(args)

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import (make_inference_step,
                                                    make_pose_fn)
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model

    cfg = Config.ycb()
    model = build_model(cfg.model, args.seed)
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    step = make_inference_step(cfg, model, mesh_kps, radii)
    pose_fn = make_pose_fn(cfg, mesh_kps, radii)
    dev = torch.device("cuda")
    batch = synthetic_batch(cfg, batch_size=1, seed=args.seed)
    pc, rgb, choose = (torch.as_tensor(batch[k], device=dev)
                       for k in ("pointcloud", "rgb", "choose"))
    step(batch)

    with torch.inference_mode():
        dtype = model.dtype
        emb, _ = model.cnn.model(rgb.to(dtype))
        cld = model.pointnet2(pc, dtype)
        rgb_emb = torch.gather(
            emb.reshape(1, -1, emb.shape[-1]), 1,
            choose.long()[..., None].expand(-1, -1, emb.shape[-1]))
        out = model(pc, rgb, choose)
        seg = torch.argmax(out["seg_logits"], -1).to(torch.int32)

        def heads():
            fused = model.rgbd_feat(rgb_emb, cld)
            return [m(fused) for m in (model.SEG_layer, model.KpOF_layer,
                                       model.CtrOf_layer)]
        stages = {
            "image branch (ResNet34 + PSP + 3 upsamples)":
                lambda: model.cnn.model(rgb.to(dtype)),
            "point branch (PointNet++ 4 SA + 4 FP)":
                lambda: model.pointnet2(pc, dtype),
            "fusion + 3 heads": heads,
            "votes -> poses (3 MeanShift passes + fit)":
                lambda: pose_fn(pc[..., :3], seg, out["ctr_offsets"],
                                out["kp_offsets"]),
            "whole request (make_inference_step)": lambda: step(batch),
        }
        for name, fn in stages.items():
            print(f"[stage] {name}: {_time_ms(fn):.3f} ms", flush=True)

    _trace(lambda i: step(synthetic_batch(cfg, batch_size=1,
                                          seed=args.seed + i)),
           args.requests, "request")
    return 0


if __name__ == "__main__":
    sys.exit(main())
