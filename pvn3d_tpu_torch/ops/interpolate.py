"""3-nearest-neighbour search and inverse-distance-weighted interpolation.

Port of the JAX package's ``ops/interpolate.py`` and of the fused
``ops/pallas/interp.py`` entry.  Selection is exact: the 3 known points
smallest in (d^2, index) order, d^2 in the direct form.  Both the fused
blend and ``three_nn`` go through kernel K3 on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.interp import three_interpolate_fused

__all__ = ["three_nn", "three_interpolate", "idw_weights",
           "three_interpolate_fused"]


def three_nn(unknown: torch.Tensor,
             known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (dist (B, n, 3) float32 euclidean distances,
    idx (B, n, 3) int32), nearest first."""
    empty = known.new_zeros(known.shape[:2] + (0,))
    _, dist, idx = three_interpolate_fused(unknown, known, empty)
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
