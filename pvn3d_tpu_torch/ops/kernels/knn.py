"""k-NN search on 3-D points, k = 1 or 16 (``csrc/knn.cu``), beside its
plain version: ``knn(query (B, Q, 3), cand (B, C, 3), k)`` -> (B, Q, k)
int32, the entry point of FFB6D's neighbour index.

Replaces no TPU kernel: FFB6D's fusion index (``data/ffb6d_index.py``)
needs 22 searches a frame, 16 nearest or 1 nearest, on up to 76800
queries or candidates, and the JAX package runs PVN3D only.  K2 keeps the
first hits inside a radius and K3 exactly 3, so neither serves.

Semantics: the k candidates smallest in lexicographic (d^2, index) order,
the direct-form d^2 of every kernel here (``common.sqdist``), nearest
first; with fewer than k candidates the empty slots repeat the nearest.
Bound on the card: operations (8 flops a query-candidate pair); no
Q x C matrix is written.  One design (warp-select: a warp per query, the
top-16 spread over its lanes and a candidate inserted by one shuffle); a
search with few queries is split into candidate segments and merged
(``segments``; the source note in ``knn.cu`` says why two other designs
went).

The wrapper takes the plain version for CPU tensors and launches a kernel
for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
KERNEL = CudaKernel("knn", "knn.cu", "knn_launch", _ARGTYPES)
KS = (1, 16)
# Queries a block (kSelectWarps in knn.cu), the blocks a search should
# reach before it is split into candidate segments (2 per SM of an H100's
# 132), and the fewest candidates a segment scans.
_BLOCK = 8
_MIN_BLOCKS = 2 * 132
_MIN_SEGMENT = 4096
# Plain version: the most (query, candidate) pairs a chunk holds.
_CHUNK_PAIRS = 1 << 22


def segments(b: int, nq: int, nc: int) -> int:
    """Candidate segments of a launch: 1 when the queries alone reach
    ``_MIN_BLOCKS`` blocks, else enough segments to reach it, each
    scanning at least ``_MIN_SEGMENT`` candidates."""
    blocks = b * -(-nq // _BLOCK)
    if blocks >= _MIN_BLOCKS:
        return 1
    return max(1, min(-(-_MIN_BLOCKS // blocks), nc // _MIN_SEGMENT))


def knn_plain(query: torch.Tensor, cand: torch.Tensor, k: int
              ) -> torch.Tensor:
    """Plain PyTorch version: (B, Q, 3), (B, C, 3) -> (B, Q, k) int32, the
    same order and padding as the kernel; brute force in chunks of
    queries (argmin for k = 1, which returns the first minimum; a stable
    sort otherwise)."""
    query, cand = query.float(), cand.float()
    b, nq, _ = query.shape
    nc = cand.shape[1]
    rows = max(1, _CHUNK_PAIRS // max(nc, 1))
    outs = []
    for s in range(0, nq, rows):
        d2 = sqdist(query[:, s:s + rows, None, :], cand[:, None, :, :])
        if k == 1:
            outs.append(torch.argmin(d2, dim=-1, keepdim=True))
        else:
            outs.append(torch.sort(d2, dim=-1, stable=True).indices[..., :k])
    idx = torch.cat(outs, dim=1) if outs else torch.zeros(
        (b, 0, min(k, nc)), dtype=torch.long, device=query.device)
    if nc < k:
        idx = torch.cat([idx, idx[..., :1].expand(-1, -1, k - nc)], dim=-1)
    return idx.to(torch.int32)


def knn(query: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """The (B, Q, k) int32 indices of each query's k nearest candidates
    (k in ``KS``)."""
    if k not in KS:
        raise ValueError(f"knn: k must be one of {KS}, got {k}")
    if query.dim() != 3 or cand.dim() != 3 or query.shape[-1] != 3 \
            or cand.shape[-1] != 3 or query.shape[0] != cand.shape[0]:
        raise ValueError(f"knn takes (B, Q, 3) and (B, C, 3); got "
                         f"{tuple(query.shape)}, {tuple(cand.shape)}")
    if cand.shape[1] < 1:
        raise ValueError("knn: no candidates")
    if query.device.type == "cpu" and cand.device.type == "cpu":
        return knn_plain(query, cand, k)
    dev = require_cuda(query, cand)
    b, nq, _ = query.shape
    nc = cand.shape[1]
    out = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    nseg = segments(b, nq, nc)
    query = query.float().contiguous()
    cand = cand.float().contiguous()
    part_d = part_i = None
    if nseg > 1:
        part_d = torch.empty(b * nseg * k * nq, dtype=torch.float32,
                             device=dev)
        part_i = torch.empty(b * nseg * k * nq, dtype=torch.int32,
                             device=dev)
    KERNEL.launch(
        dev, query.data_ptr(), cand.data_ptr(), b, nq, nc, k, nseg,
        None if part_d is None else part_d.data_ptr(),
        None if part_i is None else part_i.data_ptr(), out.data_ptr())
    return out
