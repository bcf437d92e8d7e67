"""Ball query and feature grouping (channels-last).

Port of the JAX package's ``ops/grouping.py``.  ``ball_query_multi`` is
the exact multi-scale query through kernel K2: per centroid the first
``nsample`` points in index order with d^2 < r^2, trailing slots repeating
the first hit, 0 when nothing hits (ball_query_gpu.cu:26-43).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from pvn3d_tpu_torch.ops.kernels.query import ball_query


def ball_query_multi(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> List[torch.Tensor]:
    """(B, N, 3), (B, m, 3) -> [(B, m, ns) int32 per scale]; the scales
    share one scan of the points."""
    return ball_query(radii, nsamples, xyz, new_xyz)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, m, ns) -> (B, m, ns, C)."""
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns, 1).long().expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(b, m, ns, -1)
