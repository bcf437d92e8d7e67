"""K3: exact 3-NN + IDW blend, forward (``csrc/interp.cu``) and backward
(``csrc/interp_bwd.cu``), each beside its plain version.

Replaces ``pvn3d_tpu/ops/pallas/interp.py::three_interpolate_fused``:
``_fused_fwd`` / ``_interp_kernel`` forward and the custom VJP
``_fused_bwd`` backward, joined here by ``ThreeInterpolateFused`` (a
``torch.autograd.Function``).

Forward.  Bound on the card: bytes (the n*C float32 output, fp0 12.6 MB;
the n*m direct-form distance tests, fp0 25M, are a few microseconds).  A
warp per unknown row (1, 2 or 4 rows per warp, ``forward_grid``, so every
level fills the card): lane l scans the known points j = l (mod 32) with a
running top-3, a ``__shfl_xor_sync`` butterfly merges the 32 lists under
the total (d^2, index) order, and the same warp writes the blend with
lanes along the channels in float4 (source note in ``interp.cu``).  The
TPU blend was a bf16 MXU matmul; this one is float32.

The expanded instance (``KERNEL_EXPANDED``, ``expanded=True``) is the XLA
arm of the JAX package's ``interp_mode`` "exact" / "approx"
(``ops/interpolate.py:22-70``: ``three_nn``, ``idw_weights``,
``three_interpolate``): d^2 in the expanded form ``(|u|^2 - 2 u.k) +
|k|^2`` (``common.sqdist_expanded``), the same (d^2, index) order and
``sqrt(max(d^2, 0))``.  Off a TPU ``approx_min_k`` is exact, so both modes
are this one function.  It counts its own launches; the blend and the
backward are shared.

Backward.  ``g_features[b, idx[b,i,k], :] += w[b,i,k] * g_out[b,i,:]``, with
``w`` recomputed from the saved distances in the forward's own order
``(r0 + r1) + r2``; the coordinates get no gradient.  Bound: bytes (g_out
read once, g_features written once).  The JAX package promises a
deterministic scatter-add; the kernel builds inverted lists by a stable
counting sort of the flattened ``idx`` (tiles of 1024 entries ranked in
order, a scan, a fill) and sums each destination's list in ``(i, k)``
order with no atomics (source note in ``interp_bwd.cu``), so two runs agree
bit for bit and it equals ``three_interpolate_backward_plain``, which sums
in the same order.  Its scratch (lists, ranks, per-tile counts) is
allocated here and passed in.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist, sqdist_expanded)

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
KERNEL = CudaKernel("interp", "interp.cu", "three_interp_launch",
                    _FWD_ARGTYPES)
KERNEL_EXPANDED = CudaKernel("interp_expanded", "interp.cu",
                             "three_interp_launch", _FWD_ARGTYPES)
KERNEL_BWD = CudaKernel(
    "interp_bwd", "interp_bwd.cu", "three_interp_bwd_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
# Forward launch: warps per block, and the blocks a level should reach
# before rows are packed more than one to a warp (4 per SM of an H100's
# 132, so every level at batch 1 launches at least 132).
_FWD_WARPS = 2
_FWD_MIN_BLOCKS = 4 * 132
# Backward: flattened entries per rank tile (kTile in interp_bwd.cu, which
# checks the tile count it is given).
BWD_TILE = 1024
# d^2 of an empty neighbour slot when m < 3 (interp.py:83-87 of the JAX
# package; the reference's initialised running-min slots).
_EMPTY = 1e30


def forward_grid(b: int, n: int) -> Tuple[int, int, int]:
    """The forward kernel's launch for B = ``b``, n = ``n`` unknown rows:
    (rows per warp, warps per block, blocks).  One row per warp unless the
    level has rows to spare; then 2 or 4, so each warp's known-point loads
    serve several rows."""
    for rows in (4, 2, 1):
        groups = -(-n // rows)
        blocks = -(-groups // _FWD_WARPS) * b
        if blocks >= _FWD_MIN_BLOCKS or rows == 1:
            return rows, _FWD_WARPS, blocks


def backward_scratch_words(b: int, n: int, m: int) -> int:
    """int32 words of the backward kernel's scratch: the (i, w) lists (two
    words an entry), the ranks, two (B, tiles, m) count tables, the list
    starts and the list of long lists (see ``interp_bwd.cu``)."""
    tiles = -(-3 * n // BWD_TILE)
    return 3 * b * 3 * n + 2 * b * tiles * m + b * (m + 1) + b * (m + 1)


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor,
                   chunk: int = 2048, expanded: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (d^2 (B, n, 3) float32, idx (B, n, 3)
    int64): the 3 smallest known points in lexicographic (d^2, index)
    order, three rounds of successor extraction (the Pallas kernel's);
    d^2 direct, or ``expanded``."""
    m = known.shape[1]
    col = torch.arange(m, device=known.device)
    vals, idxs = [], []
    for s in range(0, unknown.shape[1], chunk):
        u = unknown[:, s:s + chunk]
        d2 = (sqdist_expanded(u, known) if expanded
              else sqdist(u[:, :, None, :], known[:, None, :, :]))
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
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def _idw_weights(dist: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised inverse-distance weights in the forward kernel's order."""
    recip = 1.0 / (dist + eps)
    return recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor,
                            features: torch.Tensor, eps: float = 1e-8,
                            expanded: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the kernel: same selection, weights and
    float32 blend order; d^2 direct, or ``expanded``."""
    unknown, known, features = unknown.float(), known.float(), \
        features.float()
    d2, idx = three_nn_plain(unknown, known, expanded=expanded)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    w = _idw_weights(dist, eps)
    b, n, _ = idx.shape
    g = torch.gather(features, 1,
                     idx.reshape(b, n * 3, 1).expand(-1, -1,
                                                     features.shape[-1]))
    g = g.reshape(b, n, 3, -1)
    out = (w[..., 0:1] * g[:, :, 0] + w[..., 1:2] * g[:, :, 1]) \
        + w[..., 2:3] * g[:, :, 2]
    return out, dist, idx.to(torch.int32)


def three_interpolate_backward_plain(g_out: torch.Tensor, idx: torch.Tensor,
                                     dist: torch.Tensor, m: int,
                                     eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: (B, n, C), (B, n, 3),
    (B, n, 3) -> g_features (B, m, C) float32.  Every row's sum is taken
    in ``(i, k)`` order, one hit per round over the rows' stably sorted hit
    lists, each term rounded before it is added, so the result does not
    depend on the device."""
    g_out = g_out.float()
    b, n, c = g_out.shape
    out = torch.zeros((b, m, c), dtype=torch.float32, device=g_out.device)
    if out.numel() == 0 or n == 0:
        return out
    w = _idw_weights(dist.float(), eps).reshape(b, n * 3)
    flat = idx.reshape(b, n * 3).long()
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((b, m), dtype=torch.long, device=g_out.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.cumsum(counts, dim=1) - counts
    for r in range(int(counts.max())):
        live = counts > r
        pos = torch.gather(order, 1, (start + r).clamp(max=n * 3 - 1))
        rows = torch.div(pos, 3, rounding_mode="floor")
        term = torch.gather(w, 1, pos)[..., None] * torch.gather(
            g_out, 1, rows[..., None].expand(-1, -1, c))
        out = torch.where(live[..., None], out + term, out)
    return out


def three_interpolate_backward(g_out: torch.Tensor, idx: torch.Tensor,
                               dist: torch.Tensor, m: int,
                               eps: float = 1e-8) -> torch.Tensor:
    """The gradient of the blend with respect to the known features:
    g_out (B, n, C), idx (B, n, 3) int32 and dist (B, n, 3) as the forward
    returned them -> (B, m, C) float32."""
    tensors = (g_out, idx, dist)
    if all(t.device.type == "cpu" for t in tensors):
        return three_interpolate_backward_plain(g_out, idx, dist, m, eps)
    dev = require_cuda(*tensors)
    b, n, c = g_out.shape
    if idx.shape != (b, n, 3) or dist.shape != (b, n, 3):
        raise ValueError(
            f"three_interpolate_backward takes (B, n, C), (B, n, 3), "
            f"(B, n, 3); got {tuple(g_out.shape)}, {tuple(idx.shape)}, "
            f"{tuple(dist.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # Autograd may hand over a bf16 or strided cotangent.
    g_out = g_out.float().contiguous()
    idx = idx.contiguous()
    dist = dist.float().contiguous()
    scratch = torch.empty(backward_scratch_words(b, n, m), dtype=torch.int32,
                          device=dev)
    KERNEL_BWD.launch(dev, g_out.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                      b, n, m, c, eps, -(-3 * n // BWD_TILE),
                      scratch.data_ptr(), out.data_ptr())
    return out


def _forward(unknown: torch.Tensor, known: torch.Tensor,
             features: torch.Tensor, eps: float, expanded: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    tensors = (unknown, known, features)
    if all(t.device.type == "cpu" for t in tensors):
        return three_interpolate_plain(unknown, known, features, eps,
                                       expanded)
    dev = require_cuda(*tensors)
    b, n, _ = unknown.shape
    m = known.shape[1]
    c = features.shape[-1]
    if (unknown.shape[-1] != 3 or known.shape != (b, m, 3)
            or features.shape[:2] != (b, m)):
        raise ValueError(
            f"three_interpolate_fused takes (B, n, 3), (B, m, 3), (B, m, C);"
            f" got {tuple(unknown.shape)}, {tuple(known.shape)}, "
            f"{tuple(features.shape)}")
    if m < 1:
        raise ValueError("three_interpolate_fused needs m >= 1 known points")
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out, dist, idx
    unknown = unknown.float().contiguous()
    known = known.float().contiguous()
    features = features.float().contiguous()
    rows, warps, _ = forward_grid(b, n)
    kernel = KERNEL_EXPANDED if expanded else KERNEL
    kernel.launch(dev, unknown.data_ptr(), known.data_ptr(),
                  features.data_ptr(), b, n, m, c, eps, rows, warps,
                  out.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                  int(expanded))
    return out, dist, idx


class ThreeInterpolateFused(torch.autograd.Function):
    """K3 forward and backward as one differentiable function: the
    counterpart of the JAX package's ``custom_vjp``.  The gradient reaches
    ``features`` only; ``dist`` and ``idx`` are not differentiable and the
    coordinates are data."""

    @staticmethod
    def forward(ctx, unknown, known, features, eps, expanded):
        out, dist, idx = _forward(unknown, known, features, eps, expanded)
        ctx.mark_non_differentiable(dist, idx)
        ctx.save_for_backward(dist, idx)
        ctx.eps = eps
        ctx.m = known.shape[1]
        ctx.dtype = features.dtype
        return out, dist, idx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, _g_dist, _g_idx):
        dist, idx = ctx.saved_tensors
        g_feat = three_interpolate_backward(g_out, idx, dist, ctx.m, ctx.eps)
        return None, None, g_feat.to(ctx.dtype), None, None


def three_interpolate_fused(unknown: torch.Tensor, known: torch.Tensor,
                            features: torch.Tensor, eps: float = 1e-8,
                            expanded: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fused exact 3-NN IDW interpolation: (B, n, 3), (B, m, 3), (B, m, C)
    -> (out (B, n, C) float32, dist (B, n, 3), idx (B, n, 3) int32); d^2
    direct, or ``expanded`` (the XLA arm).  Differentiable with respect to
    ``features``; where no gradient is asked for (serving under
    ``torch.inference_mode``) it is the forward launch alone and saves
    nothing."""
    if torch.is_grad_enabled() and features.requires_grad:
        return ThreeInterpolateFused.apply(unknown, known, features, eps,
                                           expanded)
    return _forward(unknown, known, features, eps, expanded)
