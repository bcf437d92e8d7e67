"""K4 (MeanShift winner statistics) times per pass on the card, for one
checkout.

    python3 pvn3d_tpu_torch/tools/k4_passes.py [--root DIR] [--label NAME]

Imports ``pvn3d_tpu_torch`` from the checkout at ``--root`` (default: the
one holding this file), builds its K4 kernel and times the pose stage's
three winner passes (H = 21, 21, 168 hypotheses of K = 512 points,
bandwidth 0.08) on two inputs:

- ``synthetic``: clustered votes (three tight modes plus scatter), every
  hypothesis 70% valid: the most work a pass can get;
- ``pose``: the three passes' own inputs, captured from the pose stage
  (``make_pose_fn`` of ``Config.ycb()``) on labelled votes of a
  ``synthetic_batch`` frame (its labels as the seg map, its target offsets
  plus 5 mm noise as the predicted offsets), so only the classes present
  in the frame have valid points.

Prints one JSON line per (input, pass): the valid points, CUDA-event ms per
call (median of 5 runs of 20 calls) and device ms per call from a
``torch.profiler`` trace.  The inputs are made from fixed seeds, so two
checkouts run in turns in one call (parent, change, change, parent)
compare on one card.  Needs a card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

PASSES = ("centers", "centers (refined)", "keypoints")


def synthetic_passes(dev, seed: int = 0):
    """[(pass, points (H, 512, 3), mask (H, 512))] for H = 21, 21, 168:
    clustered votes, 70% valid."""
    rng = np.random.RandomState(seed)
    out = []
    for name, h in zip(PASSES, (21, 21, 168)):
        modes = rng.randn(h, 3, 3).astype(np.float32) * 0.1
        pick = rng.randint(0, 3, (h, 512))
        votes = (modes[np.arange(h)[:, None], pick]
                 + rng.randn(h, 512, 3).astype(np.float32) * 0.03)
        out.append((name, torch.tensor(votes, device=dev),
                    torch.tensor(rng.rand(h, 512) < 0.7, device=dev)))
    return out


def labelled_votes(cfg, seed: int):
    """Votes a trained network would give on a ``synthetic_batch`` frame:
    (pcld (1, N, 3), seg (1, N), ctr_of (1, 1, N, 3), kp_of (1, n_kps, N,
    3)) as CPU tensors."""
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    batch = synthetic_batch(cfg, batch_size=1, seed=seed)
    rng = np.random.RandomState(seed)
    ctr_of = -np.transpose(batch["ctr_targ_ofst"], (0, 2, 1, 3))
    kp_of = -np.transpose(batch["kp_targ_ofst"], (0, 2, 1, 3))
    ctr_of = ctr_of + rng.normal(0, 0.005, ctr_of.shape)
    kp_of = kp_of + rng.normal(0, 0.005, kp_of.shape)
    return (torch.tensor(batch["pointcloud"][..., :3]),
            torch.tensor(batch["labels"]),
            torch.tensor(ctr_of, dtype=torch.float32),
            torch.tensor(kp_of, dtype=torch.float32))


def pose_stage_passes(dev, seed: int = 1):
    """[(pass, points, mask)]: the three winner inputs of the pose stage
    on labelled votes, captured by wrapping ``winner_stats`` where
    ``mean_shift_fit`` calls it."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.inference import meanshift
    from pvn3d_tpu_torch.inference.pipeline import make_pose_fn
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    cfg = Config.ycb()
    fn = make_pose_fn(cfg, stacked_mesh_kps(), stacked_class_radii(),
                      device=dev)
    seen = []
    real = meanshift.winner_stats

    def recording(points, mask, bandwidth):
        seen.append((points.clone(), mask.clone()))
        return real(points, mask, bandwidth)
    meanshift.winner_stats = recording
    try:
        with torch.inference_mode():
            fn(*(v.to(dev) for v in labelled_votes(cfg, seed)))
    finally:
        meanshift.winner_stats = real
    if len(seen) != len(PASSES):
        raise RuntimeError(f"the pose stage ran {len(seen)} winner passes")
    return [(name, p, m) for name, (p, m) in zip(PASSES, seen)]


def event_ms(fn, reps: int = 20) -> float:
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


def device_ms(fn, reps: int = 10) -> float:
    from torch.autograd import DeviceType
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("k4_passes: no CUDA device", flush=True)
        return 1
    from pvn3d_tpu_torch.ops.kernels import winner
    if not winner.__file__.startswith(root):
        raise RuntimeError(f"imported {winner.__file__}, not from {root}")
    dev = torch.device("cuda")
    bw = 0.08
    inputs = [("synthetic", synthetic_passes(dev)),
              ("pose", pose_stage_passes(dev))]
    for kind, passes in inputs:
        for name, pts, msk in passes:
            got = winner.winner_stats(pts, msk, bw)
            want = winner.winner_stats_plain(pts, msk, bw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{kind} {name}: kernel differs")
            v = msk.sum(1)

            def fn():
                return winner.winner_stats(pts, msk, bw)
            print(json.dumps({
                "label": args.label, "input": kind, "pass": name,
                "H": pts.shape[0], "K": pts.shape[1], "valid": int(v.sum()),
                "hypotheses_with_points": int((v > 0).sum()),
                "most_valid": int(v.max()), "ms": event_ms(fn),
                "device_ms": device_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
