"""Synthetic batches with the exact training-batch contract (numpy only;
a copy of the JAX package's ``data/synthetic.py``).

Stand-in for the disk datasets in tests/benchmarks (no dataset checkout in
CI).  Field names and shapes mirror the reference dataset 11-tuple
(pvn3d/datasets/ycb/ycb_dataset.py:296-306) in the framework's dict form:

  pointcloud    (B, N, 9)   xyz + rgb + normal
  rgb           (B, H, W, 3)
  choose        (B, N)      flat pixel index of each sampled point
  labels        (B, N)      int32 semantic class per point
  kp_targ_ofst  (B, N, n_kps, 3)
  ctr_targ_ofst (B, N, 1, 3)
  cls_ids       (B, n_obj)  GT object ids (0 = absent)
  rts           (B, n_obj, 3, 4) GT poses
"""
from __future__ import annotations

import numpy as np

from pvn3d_tpu_torch.config import Config


def synthetic_batch(cfg: Config, batch_size: int = 2, n_points: int = 0,
                    height: int = 0, width: int = 0, seed: int = 0,
                    n_fg_objects: int = 3):
    m = cfg.model
    n = n_points or m.n_sample_points
    h = height or m.image_height
    w = width or m.image_width
    n_obj = min(n_fg_objects, m.n_classes - 1)
    rng = np.random.RandomState(seed)

    rgb = rng.rand(batch_size, h, w, 3).astype(np.float32)
    choose = rng.randint(0, h * w, (batch_size, n)).astype(np.int32)

    # Clustered foreground objects + background scatter.
    xyz = rng.uniform(-0.6, 0.6, (batch_size, n, 3)).astype(np.float32)
    xyz[..., 2] += 1.0
    labels = np.zeros((batch_size, n), np.int32)
    kp_t = np.zeros((batch_size, n, m.n_keypoints, 3), np.float32)
    ctr_t = np.zeros((batch_size, n, 1, 3), np.float32)
    cls_ids = np.zeros((batch_size, n_obj), np.int32)
    rts = np.tile(np.eye(3, 4, dtype=np.float32), (batch_size, n_obj, 1, 1))

    per = n // (2 * n_obj)
    for b in range(batch_size):
        for o in range(n_obj):
            cls = o + 1
            sl = slice(o * per, (o + 1) * per)
            center = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
            center[2] += 1.0
            pts = center + rng.normal(0, 0.03, (per, 3)).astype(np.float32)
            xyz[b, sl] = pts
            labels[b, sl] = cls
            kps = center + rng.uniform(-0.05, 0.05,
                                       (m.n_keypoints, 3)).astype(np.float32)
            kp_t[b, sl] = kps[None, :, :] - pts[:, None, :]
            ctr_t[b, sl, 0] = center[None] - pts
            cls_ids[b, o] = cls
            rts[b, o, :, 3] = center

    feats = rng.rand(batch_size, n, 6).astype(np.float32)
    pointcloud = np.concatenate([xyz, feats], axis=-1)
    return {
        "pointcloud": pointcloud, "rgb": rgb, "choose": choose,
        "labels": labels, "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t,
        "cls_ids": cls_ids, "rts": rts,
    }


def synth_sensor_frame(h: int = 480, w: int = 640, seed: int = 0):
    """A raw RGB-D sensor frame (a copy of the JAX package's
    ``benchmarks/raw_pipeline_bench.py::synth_sensor_frame``): a slanted
    plane and a box, 2 mm depth noise, 5% dropout holes, random colours.
    Returns rgb (1, H, W, 3) 0-255, depth (1, H, W) in metres and the YCB
    intrinsics (1, 3, 3), all float32 numpy."""
    rng = np.random.RandomState(seed)
    d = np.full((h, w), 1.2, np.float32)
    d += np.linspace(0, 0.3, w)[None, :]
    d[160:320, 200:440] = 0.8
    d += 0.002 * rng.randn(h, w).astype(np.float32)
    holes = rng.rand(h, w) < 0.05
    d[holes] = 0.0
    rgb = (rng.rand(h, w, 3) * 255).astype(np.float32)
    k = np.array([[1066.778, 0, 312.986],
                  [0, 1067.487, 241.310],
                  [0, 0, 1]], np.float32)
    return rgb[None], d[None], k[None]
