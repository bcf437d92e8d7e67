"""Farthest-point sampling and index gathering (channels-last).

Port of the JAX package's ``ops/sampling.py``.  ``furthest_point_sample``
is exact serial FPS (``groups=1``) through kernel K1; the grouped
(sharded) variant is a TPU latency trade the port does not run.
"""
from __future__ import annotations

import torch

from pvn3d_tpu_torch.ops.kernels.fps import fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          groups: int = 1) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32: sample 0 is index 0, then the point
    farthest from the picked set, lowest index on ties; points with
    |p|^2 <= 1e-3 are never picked (sampling_gpu.cu:92-110)."""
    if groups != 1:
        raise NotImplementedError("the port runs exact FPS only (groups=1)")
    return fps(xyz, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, m) -> (B, m, C)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)
