"""K3: exact 3-NN + IDW blend forward (``csrc/interp.cu``) and its plain
version.

Replaces ``pvn3d_tpu/ops/pallas/interp.py::three_interpolate_fused``
(``_fused_fwd`` / ``_interp_kernel``), forward only: the serving path takes
no gradient, and the backward scatter-add waits for the training slice.
Bound on the card: the n*m direct-form distance tests of the search
(fp0: 25M) and, at the finest level, the n*C float32 output (12.6 MB).
The kernel keeps a running top-3 per unknown point over shared-memory
tiles of the known points, then writes the blend with threads along the
channel axis so reads and writes are coalesced (source note in
``interp.cu``).  The TPU blend was a bf16 MXU matmul; this one is float32.

``three_interpolate_fused`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist)

KERNEL = CudaKernel(
    "interp", "interp.cu", "three_interp_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
# d^2 of an empty neighbour slot when m < 3 (interp.py:83-87 of the JAX
# package; the reference's initialised running-min slots).
_EMPTY = 1e30


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor,
                   chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (d^2 (B, n, 3) float32, idx (B, n, 3)
    int64): the 3 smallest known points in lexicographic (d^2, index)
    order, three rounds of successor extraction (the Pallas kernel's)."""
    m = known.shape[1]
    col = torch.arange(m, device=known.device)
    vals, idxs = [], []
    for s in range(0, unknown.shape[1], chunk):
        d2 = sqdist(unknown[:, s:s + chunk, None, :], known[:, None, :, :])
        pv = torch.full(d2.shape[:-1] + (1,), -1.0, device=d2.device)
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


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor,
                            features: torch.Tensor, eps: float = 1e-8
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the kernel: same selection, weights and
    float32 blend order."""
    unknown, known, features = unknown.float(), known.float(), \
        features.float()
    d2, idx = three_nn_plain(unknown, known)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    recip = 1.0 / (dist + eps)
    w = recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])
    b, n, _ = idx.shape
    g = torch.gather(features, 1,
                     idx.reshape(b, n * 3, 1).expand(-1, -1,
                                                     features.shape[-1]))
    g = g.reshape(b, n, 3, -1)
    out = (w[..., 0:1] * g[:, :, 0] + w[..., 1:2] * g[:, :, 1]) \
        + w[..., 2:3] * g[:, :, 2]
    return out, dist, idx.to(torch.int32)


def three_interpolate_fused(unknown: torch.Tensor, known: torch.Tensor,
                            features: torch.Tensor, eps: float = 1e-8
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fused exact 3-NN IDW interpolation: (B, n, 3), (B, m, 3), (B, m, C)
    -> (out (B, n, C) float32, dist (B, n, 3), idx (B, n, 3) int32)."""
    tensors = (unknown, known, features)
    if all(t.device.type == "cpu" for t in tensors):
        return three_interpolate_plain(unknown, known, features, eps)
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
    KERNEL.launch(dev, unknown.data_ptr(), known.data_ptr(),
                  features.data_ptr(), b, n, m, c, eps, out.data_ptr(),
                  dist.data_ptr(), idx.data_ptr())
    return out, dist, idx
