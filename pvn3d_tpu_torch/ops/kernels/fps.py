"""K1: farthest-point sampling (``csrc/fps.cu``) and its plain version.

Replaces ``pvn3d_tpu/ops/pallas/fps.py::fps_pallas`` (the Pallas kernels
``_fps_kernel_wide`` and ``_fps_kernel``).  Bound on the card: latency —
npoint-1 dependent steps of an O(N) update and a block-wide argmax, with
~150 KB of data per row; the kernel keeps the row and its min-d^2 cache in
registers of one 1024-thread block, so a step costs two block barriers and
no memory traffic beyond the picked point (source note in ``fps.cu``).

``fps`` takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from pvn3d_tpu_torch.ops.kernels.common import (CudaKernel, require_cuda,
                                               sqdist)

KERNEL = CudaKernel(
    "fps", "fps.cu", "fps_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])
# Rows up to this many points keep their cache in registers (fps.cu).
_REGISTER_ROW = 12 * 1024


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS with the kernel's semantics: (B, N, 3) ->
    (B, npoint) int32.  The JAX package's ``_fps_xla`` step by step."""
    xyz = xyz.float()
    b, n, _ = xyz.shape
    mag = sqdist(xyz, torch.zeros_like(xyz))
    skip = mag <= 1e-3
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    out = [last]
    for _ in range(npoint - 1):
        d = sqdist(xyz, xyz[rows, last][:, None, :])
        mind = torch.where(skip, mind, torch.minimum(mind, d))
        # torch.argmax returns the first maximal index: lowest on ties.
        last = torch.argmax(torch.where(skip, neg_inf, mind), dim=1)
        out.append(last)
    return torch.stack(out, dim=1).to(torch.int32)


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative FPS: (B, N, 3) float -> (B, npoint) int32 indices."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    dev = require_cuda(xyz)
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps takes (B, N, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if npoint < 1 or n < 1:
        raise ValueError(f"fps needs N >= 1 and npoint >= 1 (N={n}, "
                         f"npoint={npoint})")
    xyz = xyz.float().contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    scratch = torch.empty((b, n) if n > _REGISTER_ROW else (1,),
                          dtype=torch.float32, device=dev)
    KERNEL.launch(dev, xyz.data_ptr(), b, n, npoint, out.data_ptr(),
                  scratch.data_ptr())
    return out
