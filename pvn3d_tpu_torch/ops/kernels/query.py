"""K2: multi-scale ball query (``csrc/query.cu``) in the JAX package's
neighbour modes, and its plain versions.

Replaces ``pvn3d_tpu/ops/pallas/query.py::ball_query_pallas``
(``_query_kernel``) and the XLA arms of ``ops/grouping.py::
ball_query_multi``.  One kernel, four instances, each counting its own
launches:

==================  ===========================  ===========================
``KERNEL``           the JAX package's arm        d^2 and selection
==================  ===========================  ===========================
``query``            ``mode="exact"``             direct d^2, first ns hits
``query_expanded``   ``mode="approx"``            expanded d^2, first ns hits
``query_bf16``       ``compute_dtype="bf16"``     either form on coordinates
                                                  rounded to bf16
``query_capacity``   ``ball_query_pallas``        expanded d^2, at most
                     (``mode="pallas"``)          ``capacity`` hits per
                                                  residue class (index % 128),
                                                  then the first ns
==================  ===========================  ===========================

Off a TPU ``lax.approx_min_k`` is exact (equal to a sort), so the
"approx" arm is the expanded form with the exact first ns; the TPU's
recall-limited reduction has no counterpart on any other backend and
``recall`` has no effect.

Bound on the card: the data-dependent scan, at most m*N distance tests per
level.  The kernel gives each centroid one warp (2048 warps at L0): lanes
test 32 consecutive points at once, a ballot and a popcount place each hit
in its index-order slot, and the warp leaves the scan once every scale is
full; with a capacity each lane counts the hits of its four residue
classes in registers (source note in ``query.cu``).

``ball_query`` takes a plain version for a CPU tensor and launches the
kernel for a CUDA tensor; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist, sqdist_expanded)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
             ctypes.c_int, ctypes.c_int, ctypes.c_int]
KERNEL = CudaKernel("query", "query.cu", "ball_query_launch", _ARGTYPES)
KERNEL_EXPANDED = CudaKernel("query_expanded", "query.cu",
                             "ball_query_launch", _ARGTYPES)
KERNEL_BF16 = CudaKernel("query_bf16", "query.cu", "ball_query_launch",
                         _ARGTYPES)
KERNEL_CAPACITY = CudaKernel("query_capacity", "query.cu",
                             "ball_query_launch", _ARGTYPES)
_MAX_SCALES = 4
# Residue classes of the Pallas kernel's lane layout (query.py:_LANES).
CLASSES = 128


def _radius2(radius: float) -> float:
    # float32(r * r) as the JAX package compares (ops/grouping.py:144).
    return float(np.float32(radius * radius))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back to float32."""
    return t.to(torch.bfloat16).float()


def _first_hits(hit: torch.Tensor, ns: int) -> torch.Tensor:
    """(..., N) bool -> (..., ns) int64: the first ns hit indices, trailing
    slots repeating the first hit, 0 when nothing hits."""
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


def _query_plain(radii, nsamples, xyz, new_xyz, expanded: bool, bf16: bool,
                 capacity: int, chunk: int) -> List[torch.Tensor]:
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    if bf16:
        xyz, new_xyz = _bf16(xyz), _bf16(new_xyz)
    n = xyz.shape[1]
    pad = -n % CLASSES
    outs: List[List[torch.Tensor]] = [[] for _ in radii]
    for s in range(0, new_xyz.shape[1], chunk):
        cen = new_xyz[:, s:s + chunk]
        d2 = (sqdist_expanded(cen, xyz) if expanded
              else sqdist(cen[:, :, None, :], xyz[:, None, :, :]))
        for o, radius, ns in zip(outs, radii, nsamples):
            hit = d2 < _radius2(radius)
            if capacity:
                # Per residue class, the running count of hits up to and
                # including each one: kept while it is at most capacity.
                rows = F.pad(hit, (0, pad)).unflatten(-1, (-1, CLASSES))
                seen = torch.cumsum(rows.to(torch.int32), dim=-2)
                hit = (rows & (seen <= capacity)).flatten(-2)[..., :n]
            o.append(_first_hits(hit, ns))
    return [torch.cat(o, dim=1).to(torch.int32) for o in outs]


def ball_query_plain(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     expanded: bool = False, bf16: bool = False,
                     chunk: int = 512) -> List[torch.Tensor]:
    """Plain PyTorch ball query with the kernel's semantics: (B, N, 3),
    (B, m, 3) -> [(B, m, ns) int32 per scale], the first ns hit indices.
    The JAX package's ``ball_query_multi``: ``mode="exact"`` (direct d^2),
    or ``mode="approx"`` off a TPU (``expanded``); ``bf16`` rounds the
    coordinates first (``compute_dtype="bf16"``)."""
    return _query_plain(radii, nsamples, xyz, new_xyz, expanded, bf16, 0,
                        chunk)


def ball_query_capacity_plain(radii: Sequence[float],
                              nsamples: Sequence[int], xyz: torch.Tensor,
                              new_xyz: torch.Tensor, capacity: int,
                              chunk: int = 512) -> List[torch.Tensor]:
    """Plain PyTorch version of the capacity instance, the JAX package's
    ``ball_query_pallas``: expanded d^2; the hits, padded to a multiple of
    128 points and viewed as (N/128, 128), keep the first ``capacity`` of
    each column (residue class) by a running count; then the first ns kept
    hits in index order."""
    return _query_plain(radii, nsamples, xyz, new_xyz, True, False,
                        capacity, chunk)


def ball_query(radii: Sequence[float], nsamples: Sequence[int],
               xyz: torch.Tensor, new_xyz: torch.Tensor,
               expanded: bool = False, capacity: int = 0,
               bf16: bool = False) -> List[torch.Tensor]:
    """Multi-scale ball query: (B, N, 3), (B, m, 3) -> [(B, m, ns) int32
    per scale]: the first ns indices in index order with d^2 < r^2,
    trailing slots repeating the first hit, 0 when nothing hits.
    ``expanded`` computes d^2 in the expanded form, ``bf16`` on coordinates
    rounded to bfloat16; ``capacity`` > 0 keeps at most that many hits per
    residue class (index % 128) before the first ns, in the expanded form
    and float32, as the Pallas kernel does."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    if len(radii) != len(nsamples) or not 1 <= len(radii) <= _MAX_SCALES:
        raise ValueError(f"ball_query takes 1..{_MAX_SCALES} scales with "
                         f"one nsample each, got {radii} / {nsamples}")
    if capacity < 0 or (capacity and (not expanded or bf16)):
        raise ValueError(f"capacity {capacity} takes the expanded form in "
                         f"float32 (expanded={expanded}, bf16={bf16})")
    if xyz.device.type == "cpu" and new_xyz.device.type == "cpu":
        if capacity:
            return ball_query_capacity_plain(radii, nsamples, xyz, new_xyz,
                                             capacity)
        return ball_query_plain(radii, nsamples, xyz, new_xyz, expanded,
                                bf16)
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
    kernel = (KERNEL_CAPACITY if capacity else KERNEL_BF16 if bf16
              else KERNEL_EXPANDED if expanded else KERNEL)
    kernel.launch(dev, xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, s, r2,
                  ns, ptrs, int(expanded), capacity, int(bf16))
    return outs
