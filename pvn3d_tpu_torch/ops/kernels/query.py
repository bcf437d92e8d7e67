"""K2: exact multi-scale ball query (``csrc/query.cu``) and its plain
version.

Replaces ``pvn3d_tpu/ops/pallas/query.py::ball_query_pallas``
(``_query_kernel``).  The TPU kernel is exact only up to
``query_capacity`` hits per residue class; this kernel is exact, with the
reference's first-ns-in-index-order semantics.  Bound on the card: the
data-dependent scan, at most m*N direct-form distance tests per level.
The kernel gives each centroid one warp (2048 warps at L0): lanes test 32
consecutive points at once, a ballot and a popcount place each hit in its
index-order slot, and the warp leaves the scan once every scale is full
(source note in ``query.cu``).

``ball_query`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist)

KERNEL = CudaKernel(
    "query", "query.cu", "ball_query_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)])
_MAX_SCALES = 4


def _radius2(radius: float) -> float:
    # float32(r * r) as the JAX package compares (ops/grouping.py:144).
    return float(np.float32(radius * radius))


def ball_query_plain(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     chunk: int = 512) -> List[torch.Tensor]:
    """Plain PyTorch ball query with the kernel's semantics: (B, N, 3),
    (B, m, 3) -> [(B, m, ns) int32 per scale].  The JAX package's
    ``ball_query_multi(mode="exact")``: the ns smallest hit indices."""
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    n = xyz.shape[1]
    iota = torch.arange(n, device=xyz.device)
    outs: List[List[torch.Tensor]] = [[] for _ in radii]
    for s in range(0, new_xyz.shape[1], chunk):
        d2 = sqdist(new_xyz[:, s:s + chunk, None, :], xyz[:, None, :, :])
        for o, radius, ns in zip(outs, radii, nsamples):
            score = torch.where(d2 < _radius2(radius), iota, n)
            k = min(ns, n)
            vals = torch.topk(score, k, dim=-1, largest=False).values
            if k < ns:
                vals = torch.cat(
                    [vals, vals[..., :1].expand(*vals.shape[:-1], ns - k)],
                    dim=-1)
            found = vals < n
            first = torch.where(found[..., 0], vals[..., 0], 0)
            o.append(torch.where(found, vals, first[..., None]))
    return [torch.cat(o, dim=1).to(torch.int32) for o in outs]


def ball_query(radii: Sequence[float], nsamples: Sequence[int],
               xyz: torch.Tensor, new_xyz: torch.Tensor) -> List[torch.Tensor]:
    """Multi-scale ball query: (B, N, 3), (B, m, 3) -> [(B, m, ns) int32
    per scale]: the first ns indices in index order with d^2 < r^2,
    trailing slots repeating the first hit, 0 when nothing hits."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    if len(radii) != len(nsamples) or not 1 <= len(radii) <= _MAX_SCALES:
        raise ValueError(f"ball_query takes 1..{_MAX_SCALES} scales with "
                         f"one nsample each, got {radii} / {nsamples}")
    if xyz.device.type == "cpu" and new_xyz.device.type == "cpu":
        return ball_query_plain(radii, nsamples, xyz, new_xyz)
    dev = require_cuda(xyz, new_xyz)
    if (xyz.dim() != 3 or new_xyz.dim() != 3 or xyz.shape[-1] != 3
            or new_xyz.shape[-1] != 3 or xyz.shape[0] != new_xyz.shape[0]):
        raise ValueError(f"ball_query takes (B, N, 3) and (B, m, 3), got "
                         f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    outs = [torch.empty((b, m, ns), dtype=torch.int32, device=dev)
            for ns in nsamples]
    if b == 0 or m == 0:
        return outs
    if n == 0:
        return [o.zero_() for o in outs]
    xyz = xyz.float().contiguous()
    new_xyz = new_xyz.float().contiguous()
    s = len(radii)
    r2 = (ctypes.c_float * s)(*[_radius2(r) for r in radii])
    ns = (ctypes.c_int * s)(*nsamples)
    ptrs = (ctypes.c_void_p * s)(*[o.data_ptr() for o in outs])
    KERNEL.launch(dev, xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, s, r2,
                  ns, ptrs)
    return outs
