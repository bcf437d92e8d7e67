"""K4: MeanShift winner statistics (``csrc/winner.cu``) and its plain
version.

Replaces ``pvn3d_tpu/ops/pallas/winner.py::winner_stats_fused``
(``_winner_kernel``).  Bound on the card: operations, sum_h v_h^2 pair
tests over each hypothesis's v_h valid points (the keypoint pass: 168
hypotheses of up to 512) against O(H*K) bytes.  The TPU kernel held each
(K, K) tile in VMEM; this one holds nothing K x K.  One launch runs a
cluster of ``CLUSTER`` CTAs per hypothesis: every CTA compacts the valid
points into shared memory in index order, takes an equal share of the
valid seeds (two a thread, the lanes of a seed splitting the points), and
the cluster takes the largest packed (count, first index) key through
distributed shared memory; each CTA then writes its share of the winner's
row.  Rows longer than one shared-memory stage are tiled, so any K works
(source note in ``winner.cu``).

``winner_stats`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist)

KERNEL = CudaKernel(
    "winner", "winner.cu", "winner_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
CLUSTER = 8    # CTAs per hypothesis (kCluster in winner.cu)


def _bandwidth2(bandwidth: float) -> float:
    # float32(bw * bw), as the JAX package compares (meanshift.py:79).
    return float(np.float32(float(bandwidth) * float(bandwidth)))


def winner_stats_plain(points: torch.Tensor, mask: torch.Tensor,
                       bandwidth: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the kernel's direct-form d^2, first argmax."""
    points = points.float()
    mask = mask.bool()
    h, k, _ = points.shape
    bw2 = _bandwidth2(bandwidth)
    chunk = max(1, (1 << 22) // max(k * k, 1))
    wins, labels, counts = [], [], []
    for s in range(0, h, chunk):
        a = points[s:s + chunk]
        msk = mask[s:s + chunk]
        in_bw = ((sqdist(a[:, :, None, :], a[:, None, :, :]) < bw2)
                 & msk[:, None, :] & msk[:, :, None])
        num_in = in_bw.sum(dim=-1, dtype=torch.int32)
        # torch.argmax returns the first maximal index.
        win = torch.argmax(num_in, dim=-1)
        rows = torch.arange(a.shape[0], device=a.device)
        wins.append(win.to(torch.int32))
        labels.append(in_bw[rows, win])
        counts.append(num_in[rows, win])
    return torch.cat(wins), torch.cat(labels), torch.cat(counts)


def cta_threads(h: int) -> int:
    """Threads per CTA of a launch for ``h`` hypotheses on the current CUDA
    device, as the kernel picks them: 256 when all ``h`` clusters of such
    CTAs are resident on the card at once, else 128."""
    fn = KERNEL.library_function("winner_cta_threads")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    threads = fn(h)
    if threads == 0:
        raise RuntimeError("winner kernel: the device's setup failed")
    return threads


def winner_stats(points: torch.Tensor, mask: torch.Tensor, bandwidth: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, K, 3) points + (H, K) validity -> (win (H,) int32, labels (H, K)
    bool, counts (H,) int32): the seed with the most valid points within
    ``bandwidth`` of its original position (first on ties), its membership
    row and its count."""
    if points.device.type == "cpu" and mask.device.type == "cpu":
        return winner_stats_plain(points, mask, bandwidth)
    dev = require_cuda(points, mask)
    h, k, _ = points.shape
    if points.shape[-1] != 3 or mask.shape != (h, k):
        raise ValueError(f"winner_stats takes (H, K, 3) and (H, K), got "
                         f"{tuple(points.shape)} and {tuple(mask.shape)}")
    win = torch.empty((h,), dtype=torch.int32, device=dev)
    labels = torch.empty((h, k), dtype=torch.bool, device=dev)
    counts = torch.empty((h,), dtype=torch.int32, device=dev)
    if h == 0:
        return win, labels, counts
    points = points.float().contiguous()
    mask = mask.bool().contiguous()
    KERNEL.launch(dev, points.data_ptr(), mask.data_ptr(), h, k,
                  _bandwidth2(bandwidth), win.data_ptr(), labels.data_ptr(),
                  counts.data_ptr())
    return win, labels, counts
