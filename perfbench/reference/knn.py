"""Plain reference of the k-nearest-neighbour searches of FFB6D's index:
brute force over every candidate, in blocks of queries so that a block's
distance matrix stays small, ordered by (d^2, index).

d^2 is ((dx*dx)+(dy*dy))+(dz*dz) in float32, elementwise (no matmul,
no fused multiply-add).  k = 1 takes the first minimum (``argmin``);
larger k a stable sort, so an equal distance keeps the lower index first.
With fewer candidates than k the empty slots repeat the nearest.
"""
from __future__ import annotations

import torch

# The most (query, candidate) pairs a block holds.
_BLOCK_PAIRS = 1 << 24


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def knn(query: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """(B, Q, 3), (B, C, 3) -> (B, Q, k) int64, nearest first."""
    query, cand = query.float(), cand.float()
    nc = cand.shape[1]
    rows = max(1, _BLOCK_PAIRS // max(nc, 1))
    out = []
    for s in range(0, query.shape[1], rows):
        d2 = sqdist(query[:, s:s + rows, None, :], cand[:, None, :, :])
        if k == 1:
            out.append(torch.argmin(d2, dim=-1, keepdim=True))
        else:
            out.append(torch.sort(d2, dim=-1, stable=True).indices[..., :k])
        del d2
    idx = torch.cat(out, dim=1)
    if nc < k:
        idx = torch.cat([idx, idx[..., :1].expand(-1, -1, k - nc)], dim=-1)
    return idx
