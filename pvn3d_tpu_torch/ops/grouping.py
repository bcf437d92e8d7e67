"""Ball query and feature grouping (channels-last).

Port of the JAX package's ``ops/grouping.py``.  ``ball_query_multi`` is
the multi-scale query through kernel K2: per centroid the first
``nsample`` points in index order with d^2 < r^2, trailing slots repeating
the first hit, 0 when nothing hits (ball_query_gpu.cu:26-43), in the JAX
package's modes:

* "auto" / "exact": direct d^2, the first ns hits (K2 ``query``).  Off a
  TPU the JAX package's "auto" is "exact"; the port's backend is CUDA,
  where it stays so.
* "approx": expanded d^2, the first ns hits (``query_expanded``).  Off a
  TPU ``lax.approx_min_k`` is exact, so its ``recall`` (the config's
  ``query_recall``) has no effect and no parameter here: the TPU's
  recall-limited reduction has no counterpart on any other backend.
* "pallas": the Pallas kernel's selection, at most ``capacity`` hits per
  residue class (index % 128) and then the first ns, in the expanded form
  (``query_capacity``); ``compute_dtype`` is ignored, as in JAX
  (grouping.py:102-106 returns before the bf16 cast).
* ``compute_dtype="bf16"`` (with "auto", "exact" or "approx"): the
  coordinates rounded to bfloat16, then the same float32 arithmetic
  (``query_bf16``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from pvn3d_tpu_torch.ops.kernels.query import ball_query

QUERY_MODES = ("auto", "exact", "approx", "pallas")
QUERY_COMPUTE = ("f32", "bf16")


def ball_query_multi(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     mode: str = "auto", compute_dtype: str = "f32",
                     capacity: int = 2) -> List[torch.Tensor]:
    """(B, N, 3), (B, m, 3) -> [(B, m, ns) int32 per scale]; the scales
    share one scan of the points."""
    if mode not in QUERY_MODES:
        raise ValueError(f"query mode {mode!r}: one of {QUERY_MODES}")
    if compute_dtype not in QUERY_COMPUTE:
        raise ValueError(f"query compute_dtype {compute_dtype!r}: one of "
                         f"{QUERY_COMPUTE}")
    if mode == "pallas":
        if capacity < 1:
            raise ValueError(f"query capacity {capacity}: at least 1")
        return ball_query(radii, nsamples, xyz, new_xyz, expanded=True,
                          capacity=capacity)
    return ball_query(radii, nsamples, xyz, new_xyz,
                      expanded=mode == "approx",
                      bf16=compute_dtype == "bf16")


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, m, ns) -> (B, m, ns, C)."""
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns, 1).long().expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(b, m, ns, -1)
