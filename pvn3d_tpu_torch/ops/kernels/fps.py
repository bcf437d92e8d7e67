"""K1: farthest-point sampling (``csrc/fps.cu``) and its plain version.

Replaces ``pvn3d_tpu/ops/pallas/fps.py::fps_pallas`` (the Pallas kernels
``_fps_kernel_wide`` and ``_fps_kernel``).  Bound on the card: latency —
npoint-1 dependent steps of an O(N) update and an argmax over the row,
with ~150 KB of data per row.  The kernel splits the row and its min-d^2
cache over one cluster of 8 CTAs per row (registers, 6 points a thread
at N = 12288) and keeps the row's xyz in every CTA's shared memory.  Each
step every warp sends its packed (value, index) key to every CTA of the
cluster with ``st.async``, and each CTA waits on its own mbarrier for
the step's keys: no cluster-wide barrier (source note in ``fps.cu``).
Rows past 12288 points keep the cache in a global scratch row.

``fps`` takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; it never falls back from one to the other.  Where no
cluster fits on the card the launch raises.
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
