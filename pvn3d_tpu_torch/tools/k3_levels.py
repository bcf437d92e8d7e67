"""K3 forward and backward times per level on the card, for one checkout.

    python3 pvn3d_tpu_torch/tools/k3_levels.py [--root DIR] [--label NAME]

Imports ``pvn3d_tpu_torch`` from the checkout at ``--root`` (default: the
one holding this file), builds its K3 kernels and times each FP level
(fp3 .. fp0) of ``Config.ycb()``: the forward at batch 1 on a depth-camera
cloud, the backward at batch 4 on depth-camera clouds and on the training
batch's clouds (``synthetic_batch`` at batch 4, seed 0).  Prints one JSON
line per (kind, cloud, level): CUDA-event ms per call (median of 5 runs of
20 calls) and device ms per call from a ``torch.profiler`` trace, with each
kernel's share by name.  The inputs are made from fixed seeds, so two
checkouts run in turns in one call (parent, change, change, parent)
compare on one card.  Needs a card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def _depth_cloud(np, intrinsics, rng, n):
    """chip_smoke.py's depth-camera cloud: n pixels of a 480x640 camera
    back-projected from a table plane with three objects on it."""
    u = rng.randint(0, 640, n).astype(np.float32)
    v = rng.randint(0, 480, n).astype(np.float32)
    z = 0.9 + 0.15 * (v / 480.0)
    for cu, cv, r in ((220, 200, 60), (400, 260, 80), (320, 360, 50)):
        z = np.where(((u - cu) ** 2 + (v - cv) ** 2) < r * r, z - 0.08, z)
    x = (u - intrinsics[0, 2]) * z / intrinsics[0, 0]
    y = (v - intrinsics[1, 2]) * z / intrinsics[1, 1]
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("k3_levels: no CUDA device", flush=True)
        return 1
    from pvn3d_tpu_torch.config import INTRINSICS, Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.ops.kernels import fps, interp
    if not interp.__file__.startswith(root):
        raise RuntimeError(f"imported {interp.__file__}, not from {root}")
    dev = torch.device("cuda")

    def event_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / reps)
        return statistics.median(out)

    def device_ms(fn, reps=10):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = e.key.split("(anonymous namespace)::")[-1]
                name = name.split("(")[0].strip()
                parts[name] = e.self_device_time_total / 1e3 / reps
        return sum(parts.values()), parts

    cfg = Config.ycb()
    pcfg = cfg.model.pointnet2
    widths = [sum(m[-1] for m in lvl.mlps) for lvl in pcfg.sa_levels]
    known_c = [pcfg.fp_mlps[i + 1][-1] if i < 3 else widths[3]
               for i in range(4)]
    rng = np.random.RandomState(0)
    k1 = INTRINSICS["ycb_K1"]
    n = cfg.model.n_sample_points
    clouds = [
        ("fwd", "depth", _depth_cloud(np, k1, rng, n)[None]),
        ("bwd", "depth", np.stack([_depth_cloud(np, k1, rng, n)
                                   for _ in range(4)])),
        ("bwd", "train", synthetic_batch(cfg, batch_size=4, seed=0)
         ["pointcloud"][..., :3].copy()),
    ]
    m0 = pcfg.sa_levels[0].npoint
    for kind, cloud, pts in clouds:
        xyz = torch.tensor(pts, device=dev)
        b = xyz.shape[0]
        pick = fps.fps(xyz, m0)
        sub = torch.gather(xyz, 1, pick.long()[..., None].expand(-1, -1, 3))
        levels = [xyz] + [sub[:, :lvl.npoint].contiguous()
                          for lvl in pcfg.sa_levels]
        frng = np.random.RandomState(1)
        for li in range(3, -1, -1):
            unk, kn = levels[li], levels[li + 1]
            m, c = kn.shape[1], known_c[li]
            f = torch.tensor(frng.randn(b, m, c).astype(np.float32),
                             device=dev)
            if kind == "fwd":
                def fn():
                    return interp.three_interpolate_fused(unk, kn, f)
            else:
                _, dist, idx = interp.three_interpolate_fused(unk, kn, f)
                g = torch.tensor(frng.randn(b, unk.shape[1], c)
                                 .astype(np.float32), device=dev)

                def fn():
                    return interp.three_interpolate_backward(g, idx, dist, m)
            total, parts = device_ms(fn)
            print(json.dumps(dict(
                label=args.label, kind=kind, cloud=cloud, B=b,
                level=f"fp{li}", n=unk.shape[1], m=m, C=c,
                ms=event_ms(fn), device_ms=total, kernels=parts)),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
