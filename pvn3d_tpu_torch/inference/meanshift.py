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
matches it; on the card the whole loop is one launch
(``ops/kernels/meanshift.py``), which decides the rule itself.  Dense mode
iterates every seed, the literal reference fixed point, and is kept as the
oracle.  The bandwidth's float32 terms are worked out on the host, with the
rounding the device arithmetic gave them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pvn3d_tpu_torch.ops.kernels.common import sqdist
from pvn3d_tpu_torch.ops.kernels.meanshift import shift_to_stop
from pvn3d_tpu_torch.ops.kernels.winner import winner_stats
from pvn3d_tpu_torch.utils.profiling import host_read

_SQRT_2PI = 2.5066282746310002


def bandwidth_terms(bandwidth: float) -> Tuple[float, float]:
    """(bw^2, stop) of a bandwidth in float32, each rounded as the JAX
    package's ``bw * bw`` and ``bw * 1e-3`` on a float32 ``bw`` (and the
    port's float32 tensor arithmetic) round them."""
    bw = np.float32(bandwidth)
    return float(bw * bw), float(bw * np.float32(1e-3))


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
    bw2, stop = bandwidth_terms(bandwidth)
    c, _ = shift_to_stop(points, mask, win, bw2, stop, max_iter)
    return c, labels, counts


def _fit_dense(points, mask, bandwidth, max_iter):
    """Every seed iterated to its own stop (the reference fixed point)."""
    bw2, stop = bandwidth_terms(bandwidth)
    bw = np.float32(bandwidth)
    inv_norm = float(np.float32(1.0) / (bw * np.float32(_SQRT_2PI)))
    # A fill on the device, not a copy from host memory: the division
    # below stays a tensor division.
    bw2 = torch.full((), bw2, dtype=torch.float32, device=points.device)
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
        if host_read("meanshift_dense_stop", shift.max()) < stop:
            break
    in_bw = ((sqdist(points[:, :, None, :], points[:, None, :, :]) < bw2)
             & mask[:, None, :] & mask[:, :, None])
    num_in = in_bw.sum(dim=-1, dtype=torch.int32)
    win = torch.argmax(num_in, dim=-1)
    rows = torch.arange(points.shape[0], device=points.device)
    return c[rows, win], in_bw[rows, win], num_in[rows, win]
