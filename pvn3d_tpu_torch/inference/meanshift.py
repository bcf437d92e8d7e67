"""Batched masked MeanShift clustering.

Port of the JAX package's ``inference/meanshift.py``.  Every (class,
keypoint-or-center) hypothesis is one row of a padded (H, K, 3) problem.
Reference semantics (meanshift_pytorch.py:24-51): the winning seed
maximises the count of valid points within ``bandwidth`` of its ORIGINAL
position; the returned center is that seed's converged mode, the labels
its original-position membership.

Winner mode (the default) decides the winner with one (K, K) pass —
kernel K4 — and then iterates only the winning seed: O(K) per step.  The
steps run in groups of four with the stopping rule checked after each
group, exactly as the JAX package's ``while_loop`` does, so the step count
matches it.  Dense mode iterates every seed, the literal reference fixed
point, and is kept as the oracle.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.common import sqdist
from pvn3d_tpu_torch.ops.kernels.winner import winner_stats

_SQRT_2PI = 2.5066282746310002
# Shift steps between stopping-rule checks in winner mode: the JAX
# package's ``unroll`` (meanshift.py:157-163), kept so step counts match.
_UNROLL = 4


def mean_shift_fit(points: torch.Tensor, mask: torch.Tensor,
                   bandwidth: float, max_iter: int = 300,
                   mode: str = "winner"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked MeanShift on (H, K, 3) points with (H, K) validity.

    Returns centers (H, 3), labels (H, K) bool and counts (H,) int32.
    """
    points = points.float()
    mask = mask.bool()
    if mode == "dense":
        return _fit_dense(points, mask, bandwidth, max_iter)
    if mode != "winner":
        raise ValueError(f"mode {mode!r}: 'winner' or 'dense'")

    win, labels, counts = winner_stats(points, mask, bandwidth)
    bw = torch.tensor(bandwidth, dtype=torch.float32, device=points.device)
    bw2 = bw * bw
    stop = float(bw * 1e-3)
    wmask = mask.float()
    rows = torch.arange(points.shape[0], device=points.device)
    c = points[rows, win.long()]

    def shift_once(c):
        d2 = ((points - c[:, None, :]) ** 2).sum(dim=-1)
        w = torch.exp(-0.5 * d2 / bw2) * wmask
        wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-20)
        return torch.einsum("hk,hkc->hc", w, points) / wsum

    it = 0
    while True:
        for _ in range(_UNROLL):
            new_c = shift_once(c)
            shift = torch.linalg.vector_norm(new_c - c, dim=-1)
            c = new_c
        it += _UNROLL
        # One host read per group of steps: the loop's stopping rule.
        if it >= max_iter or float(shift.max()) < stop:
            break
    return c, labels, counts


def _fit_dense(points, mask, bandwidth, max_iter):
    """Every seed iterated to its own stop (the reference fixed point)."""
    bw = torch.tensor(bandwidth, dtype=torch.float32, device=points.device)
    bw2 = bw * bw
    stop = float(bw * 1e-3)
    inv_norm = 1.0 / (bw * _SQRT_2PI)
    wmask = mask.float()[:, None, :]
    c = points
    for it in range(max_iter):
        d2 = sqdist(c[:, :, None, :], points[:, None, :, :])
        w = inv_norm * torch.exp(-0.5 * d2 / bw2) * wmask
        wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-20)
        new_c = torch.einsum("hij,hjd->hid", w, points) / wsum
        shift = torch.where(mask, torch.linalg.vector_norm(new_c - c, dim=-1),
                            0.0)
        c = new_c
        if float(shift.max()) < stop:
            break
    in_bw = ((sqdist(points[:, :, None, :], points[:, None, :, :]) < bw2)
             & mask[:, None, :] & mask[:, :, None])
    num_in = in_bw.sum(dim=-1, dtype=torch.int32)
    win = torch.argmax(num_in, dim=-1)
    rows = torch.arange(points.shape[0], device=points.device)
    return c[rows, win], in_bw[rows, win], num_in[rows, win]
