"""Plain reference of the point operations: farthest-point sampling, the
multi-scale ball query, 3-NN inverse-distance interpolation and MeanShift's
winner statistics.

Frozen copies of the port's plain versions (``ops/kernels/*.py``), which
follow the reference CUDA ops (sampling_gpu.cu, ball_query_gpu.cu,
interpolate_gpu.cu) with the direct-form d^2 ((dx*dx)+(dy*dy))+(dz*dz) of
the configuration's "auto" modes, in float32.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

_EMPTY = 1e30


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64: index 0, then the point farthest
    from the picked set (first on ties); points with |p|^2 <= 1e-3 are
    never picked."""
    xyz = xyz.float()
    b, n, _ = xyz.shape
    skip = sqdist(xyz, torch.zeros_like(xyz)) <= 1e-3
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    out = [last]
    for _ in range(npoint - 1):
        d = sqdist(xyz, xyz[rows, last][:, None, :])
        mind = torch.where(skip, mind, torch.minimum(mind, d))
        last = torch.argmax(torch.where(skip, neg_inf, mind), dim=1)
        out.append(last)
    return torch.stack(out, dim=1)


def _first_hits(hit: torch.Tensor, ns: int) -> torch.Tensor:
    n = hit.shape[-1]
    iota = torch.arange(n, device=hit.device)
    score = torch.where(hit, iota, n)
    k = min(ns, n)
    vals = torch.topk(score, k, dim=-1, largest=False).values
    if k < ns:
        vals = torch.cat(
            [vals, vals[..., :1].expand(*vals.shape[:-1], ns - k)], dim=-1)
    found = vals < n
    first = torch.where(found[..., 0], vals[..., 0], 0)
    return torch.where(found, vals, first[..., None])


def ball_query(radii: Sequence[float], nsamples: Sequence[int],
               xyz: torch.Tensor, new_xyz: torch.Tensor,
               chunk: int = 512) -> List[torch.Tensor]:
    """(B, N, 3), (B, m, 3) -> [(B, m, ns) int64 per scale]: the first ns
    indices with d^2 < float32(r*r), trailing slots repeating the first
    hit, 0 when nothing hits."""
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    outs: List[List[torch.Tensor]] = [[] for _ in radii]
    for s in range(0, new_xyz.shape[1], chunk):
        cen = new_xyz[:, s:s + chunk]
        d2 = sqdist(cen[:, :, None, :], xyz[:, None, :, :])
        for o, radius, ns in zip(outs, radii, nsamples):
            r2 = float(np.float32(radius * radius))
            o.append(_first_hits(d2 < r2, ns))
    return [torch.cat(o, dim=1) for o in outs]


def three_interpolate(unknown: torch.Tensor, known: torch.Tensor,
                      features: torch.Tensor, eps: float = 1e-8,
                      chunk: int = 2048) -> torch.Tensor:
    """(B, n, 3), (B, m, 3), (B, m, C) -> (B, n, C): the 3 known points
    smallest in (d^2, index) order, inverse-distance weights."""
    unknown, known = unknown.float(), known.float()
    m = known.shape[1]
    col = torch.arange(m, device=known.device)
    vals, idxs = [], []
    for s in range(0, unknown.shape[1], chunk):
        d2 = sqdist(unknown[:, s:s + chunk, None, :], known[:, None, :, :])
        pv = torch.full(d2.shape[:-1] + (1,), float("-inf"),
                        device=d2.device)
        pi = torch.full(d2.shape[:-1] + (1,), -1, dtype=torch.long,
                        device=d2.device)
        v3, i3 = [], []
        for _ in range(3):
            elig = (d2 > pv) | ((d2 == pv) & (col > pi))
            v = torch.where(elig, d2, _EMPTY).amin(dim=-1, keepdim=True)
            i = torch.where(elig & (d2 == v), col, m).amin(dim=-1,
                                                           keepdim=True)
            v3.append(v)
            i3.append(i)
            pv, pi = v, i
        v = torch.cat(v3, dim=-1)
        vals.append(v)
        idxs.append(torch.where(v >= _EMPTY, 0, torch.cat(i3, dim=-1)))
    dist = torch.sqrt(torch.clamp(torch.cat(vals, dim=1), min=0.0))
    idx = torch.cat(idxs, dim=1)
    recip = 1.0 / (dist + eps)
    w = recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])
    b, n, _ = idx.shape
    g = torch.gather(features, 1, idx.reshape(b, n * 3, 1).expand(
        -1, -1, features.shape[-1])).reshape(b, n, 3, -1)
    return (w[..., 0:1] * g[:, :, 0] + w[..., 1:2] * g[:, :, 1]) \
        + w[..., 2:3] * g[:, :, 2]


def winner_stats(points: torch.Tensor, mask: torch.Tensor,
                 bandwidth: float):
    """(H, K, 3), (H, K) -> (win (H,), labels (H, K) bool, counts (H,)):
    the seed with the most valid points within ``bandwidth`` (first on
    ties), its membership row and its count."""
    points = points.float()
    mask = mask.bool()
    h, k, _ = points.shape
    bw2 = float(np.float32(float(bandwidth) * float(bandwidth)))
    chunk = max(1, (1 << 22) // max(k * k, 1))
    wins, labels, counts = [], [], []
    for s in range(0, h, chunk):
        a = points[s:s + chunk]
        msk = mask[s:s + chunk]
        in_bw = ((sqdist(a[:, :, None, :], a[:, None, :, :]) < bw2)
                 & msk[:, None, :] & msk[:, :, None])
        num_in = in_bw.sum(dim=-1, dtype=torch.int32)
        win = torch.argmax(num_in, dim=-1)
        rows = torch.arange(a.shape[0], device=a.device)
        wins.append(win)
        labels.append(in_bw[rows, win])
        counts.append(num_in[rows, win])
    return torch.cat(wins), torch.cat(labels), torch.cat(counts)
