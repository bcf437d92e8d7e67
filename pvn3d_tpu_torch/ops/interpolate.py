"""3-nearest-neighbour search and inverse-distance-weighted interpolation.

Port of the JAX package's ``ops/interpolate.py`` and of the fused
``ops/pallas/interp.py`` entry.  Selection is exact: the 3 known points
smallest in (d^2, index) order.  ``mode`` picks the d^2 form as the JAX
package's ``interp_mode`` does: "auto" and "pallas" are its fused Pallas
kernel (direct d^2; K3 ``interp``), "exact" and "approx" its XLA
``three_nn`` (expanded d^2, then ``sqrt(max(d^2, 0))``; K3
``interp_expanded``; off a TPU ``approx_min_k`` is exact).
"""
from __future__ import annotations

from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.interp import three_interpolate_fused

__all__ = ["three_nn", "three_interpolate", "idw_weights",
           "three_interpolate_fused", "interp_expanded", "INTERP_MODES"]

INTERP_MODES = ("auto", "pallas", "exact", "approx")


def interp_expanded(mode: str) -> bool:
    """Whether ``interp_mode`` ``mode`` is the XLA arm's expanded d^2."""
    if mode not in INTERP_MODES:
        raise ValueError(f"interp mode {mode!r}: one of {INTERP_MODES}")
    return mode in ("exact", "approx")


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             mode: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (dist (B, n, 3) float32 euclidean distances,
    idx (B, n, 3) int32), nearest first."""
    empty = known.new_zeros(known.shape[:2] + (0,))
    _, dist, idx = three_interpolate_fused(unknown, known, empty,
                                           expanded=interp_expanded(mode))
    return dist, idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C), (B, n, 3), (B, n, 3) -> (B, n, C) weighted blend."""
    b, n, _ = idx.shape
    flat = idx.reshape(b, n * 3, 1).long().expand(-1, -1, features.shape[-1])
    gathered = torch.gather(features, 1, flat).reshape(b, n, 3, -1)
    return torch.einsum("bnkc,bnk->bnc", gathered, weight)


def idw_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights normalised over the 3 neighbours
    (pointnet2_modules.py:183-187)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)
