"""Streaming pose service: raw RGB-D frames in, 6-DoF poses out.

Port of the JAX package's ``apps/serve.py``.  Each frame goes through
``inference.pipeline.make_raw_inference_step`` on one device: depth fill,
normals, point sampling and feature assembly, then the CNN + PointNet++
forward, MeanShift clustering and the pose fit.  Frames are submitted one
ahead of the read, as in the JAX app, and the latency of a frame runs from
its submission to its poses on the host.  The pose stage reads the host
between MeanShift steps, so a frame's step has mostly run by the time it
returns, and the next frame's step runs before the read: each latency
holds about one request's time plus the next submission's.

  python -m pvn3d_tpu_torch.apps.serve --checkpoint_dir runs/ycb --frames 200
  python -m pvn3d_tpu_torch.apps.serve --source dir --frame_dir /path/frames \
      --torch_ckpt pvn3d_best.pth.tar

``--source dir`` reads <stem>-color.png / <stem>-depth.png pairs (YCB
layout); ``--source synthetic`` serves the procedural sensor frame
(``data.synthetic.synth_sensor_frame``).  ``--out poses.jsonl`` writes one
JSON record per frame.  ``--trace_dir DIR`` then serves ``--trace_frames``
more frames, each read back before the next, under the profiler
(``utils.profiling.trace``) and writes their Chrome trace into DIR: the
port's ``pvn3d.*`` spans (a request, its stages, its blocking reads) with
the kernels each launched.  The service runs on the card unless
``--device cpu`` is given.  The last line of standard output is one JSON
object: frames a second, latency percentiles in ms, and the device.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from pvn3d_tpu_torch.config import Config

# YCB camera intrinsics of the dir source (the JAX app's).
_YCB_K = np.array([[1066.778, 0, 312.986], [0, 1067.487, 241.310],
                   [0, 0, 1]], np.float32)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", default="",
                   help="restore the latest train/checkpoint.py checkpoint")
    p.add_argument("--torch_ckpt", default="",
                   help="a reference PyTorch PVN3D checkpoint")
    p.add_argument("--source", choices=("synthetic", "dir"),
                   default="synthetic")
    p.add_argument("--frame_dir", default="",
                   help="directory of <stem>-color.png/-depth.png pairs")
    p.add_argument("--cam_scale", type=float, default=10000.0,
                   help="depth units per meter for --source dir")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--out", default="", help="write poses as jsonl")
    p.add_argument("--no_fill_depth", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--trace_dir", default="",
                   help="write a Chrome trace of --trace_frames more frames "
                        "here, after the timed ones")
    p.add_argument("--trace_frames", type=int, default=5)
    return p


def _frame_source(args, h: int, w: int):
    """Yield (rgb (H, W, 3) 0-255, depth (H, W) in metres, K (3, 3))
    float32 numpy frames forever."""
    if args.source == "dir":
        from pvn3d_tpu_torch.data.png import read_png
        stems = sorted(p[:-len("-color.png")] for p in glob.glob(
            os.path.join(args.frame_dir, "*-color.png")))
        if not stems:
            raise SystemExit(f"no *-color.png under {args.frame_dir}")
        i = 0
        while True:
            stem = stems[i % len(stems)]
            rgb = read_png(stem + "-color.png")[..., :3].astype(np.float32)
            depth = read_png(stem + "-depth.png").astype(
                np.float32) / args.cam_scale
            yield rgb, depth, _YCB_K
            i += 1
    else:
        from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame
        i = 0
        while True:
            rgb, depth, k = synth_sensor_frame(h, w, seed=i % 16)
            yield rgb[0], depth[0], k[0]
            i += 1


def _load_model(args, cfg: Config, dev: torch.device) -> torch.nn.Module:
    from pvn3d_tpu_torch.utils.weights import (build_model,
                                               load_torch_state_dict)
    if args.checkpoint_dir:
        from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
        from pvn3d_tpu_torch.train.state import create_train_state
        manager = CheckpointManager(args.checkpoint_dir)
        if manager.latest_step() is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        return manager.restore(create_train_state(cfg, 0, dev)).model
    model = build_model(cfg.model, 0)
    if args.torch_ckpt:
        model.load_state_dict(load_torch_state_dict(args.torch_ckpt),
                              strict=True)
    else:
        print("WARNING: serving RANDOM weights (latency run only)",
              flush=True)
    return model


def frame_generator(i: int, dev: torch.device) -> torch.Generator:
    """Frame ``i``'s sampling generator, seeded from (0, i) as the JAX
    app folds ``i`` into key 0."""
    seed = int(np.random.SeedSequence((0, i)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=dev).manual_seed(seed)


def main(argv=None, cfg: Optional[Config] = None) -> dict:
    """Serve ``--frames`` frames after ``--warmup`` and return the JSON
    record it prints.  ``cfg`` is the configuration served,
    ``Config.ycb()`` unless given (a small one drives the app on the
    CPU in seconds)."""
    args = build_argparser().parse_args(argv)
    from pvn3d_tpu_torch.inference.pipeline import make_raw_inference_step
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    cfg = cfg or Config.ycb()
    mc = cfg.model
    step = make_raw_inference_step(
        cfg, _load_model(args, cfg, dev), stacked_mesh_kps(mc.n_classes),
        stacked_class_radii(), fill_depth=not args.no_fill_depth,
        device=dev)

    src = _frame_source(args, mc.image_height, mc.image_width)
    lat = []
    pending = None          # (poses, present, t_submitted, frame index)
    t_start = None
    total = args.warmup + args.frames
    sink_cm = open(args.out, "w") if args.out else contextlib.nullcontext()
    with sink_cm as sink:
        for i in range(total + 1):
            submitted = None
            if i < total:
                rgb, depth, k = next(src)
                t_sub = time.perf_counter()
                if args.warmup == 0 and i == 0:
                    # No warm-up: the rate clock covers frame 0's latency.
                    t_start = t_sub
                out = step({"rgb": rgb[None], "depth": depth[None],
                            "cam_k": k[None]},
                           generator=frame_generator(i, dev))
                submitted = (out["poses"][0], out["present"][0], t_sub, i)
            if pending is not None:
                p_poses, p_present, p_t, p_i = pending
                poses_arr = p_poses.cpu().numpy()
                present = p_present.cpu().numpy()
                done = time.perf_counter()
                if p_i >= args.warmup:
                    lat.append(done - p_t)
                    if sink is not None:
                        sink.write(json.dumps(
                            {"frame": p_i - args.warmup,
                             "present": present.nonzero()[0].tolist(),
                             "poses": poses_arr[present > 0].tolist()})
                            + "\n")
                if p_i == args.warmup - 1:
                    t_start = done
            pending = submitted

    lat_ms = np.asarray(sorted(lat)) * 1e3
    wall = time.perf_counter() - (t_start or time.perf_counter())
    if args.trace_dir:
        from pvn3d_tpu_torch.utils.profiling import trace
        with trace(args.trace_dir):
            for i in range(total, total + args.trace_frames):
                rgb, depth, k = next(src)
                step({"rgb": rgb[None], "depth": depth[None],
                      "cam_k": k[None]},
                     generator=frame_generator(i, dev))["poses"].cpu()
    record = {
        "metric": "serving_fps",
        "value": args.frames / wall if wall > 0 else 0.0,
        "unit": "frames/s",
        "latency_ms": {q: float(np.percentile(lat_ms, int(q[1:])))
                       for q in ("p50", "p90", "p99")},
        "frames": args.frames,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "note": "latency from a frame's submission to its poses on the "
                "host, one frame ahead as in the JAX app: it holds the "
                "next frame's submission too",
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
