"""MeanShift's winner-mode shift loop run to its stopping rule
(``csrc/meanshift.cu``), beside its plain version.

Replaces no TPU kernel: the JAX package runs the loop as a
``lax.while_loop`` of ``jnp`` steps (``pvn3d_tpu/inference/meanshift.py::
mean_shift_fit``), which stays on the TPU.  Run eagerly, the port's loop
cost about 13 launches a step and a host read of ``max(shift)`` after every
group of 4 steps, each read draining the stream.  One launch here runs the
whole loop of a fit: a thread-block cluster of up to 8 CTAs holds every
hypothesis, a warp iterates one winning seed over its staged points, and
the cluster decides the stopping rule after each group of steps through
distributed shared memory.  Bound on the card: operations, ~30
instructions a (step, valid point) pair, against the points read once
(source note in ``meanshift.cu``).

``shift_to_stop`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pvn3d_tpu_torch.ops.kernels.common import CudaKernel, require_cuda
from pvn3d_tpu_torch.utils.profiling import annotate, host_read

KERNEL = CudaKernel(
    "meanshift", "meanshift.cu", "meanshift_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])
# Shift steps between stopping-rule checks: the JAX package's ``unroll``
# (meanshift.py:157-163), kept so step counts match.
UNROLL = 4


def launch_shape(h: int, k: int) -> Tuple[int, int, int, int]:
    """The kernel's launch for ``h`` hypotheses of ``k`` points, as its
    library computes it: (CTAs of the cluster, warps a CTA, hypotheses a
    CTA, points a hypothesis staged in shared memory)."""
    fn = KERNEL.library_function("meanshift_shape")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    fn(h, k, ctypes.addressof(out))
    return tuple(out)


def shift_to_stop_plain(points: torch.Tensor, mask: torch.Tensor,
                        win: torch.Tensor, bw2: float, stop: float,
                        max_iter: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: each step a few tensor ops, and the stopping
    rule read on the host after every group of ``UNROLL`` steps."""
    bw2 = torch.full((), bw2, dtype=torch.float32, device=points.device)
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
        for _ in range(UNROLL):
            new_c = shift_once(c)
            shift = torch.linalg.vector_norm(new_c - c, dim=-1)
            c = new_c
        it += UNROLL
        # One host read per group of steps: the loop's stopping rule.
        if it >= max_iter or host_read("meanshift_stop",
                                       shift.max()) < stop:
            break
    return c, torch.full((), it, dtype=torch.int32, device=points.device)


def shift_to_stop(points: torch.Tensor, mask: torch.Tensor,
                  win: torch.Tensor, bw2: float, stop: float, max_iter: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, K, 3) float32 points, (H, K) validity and (H,) winning seeds ->
    (centres (H, 3), steps): each seed shifted to its mode under the
    Gaussian weight exp(-0.5 d^2 / ``bw2``) over the valid points, in groups
    of ``UNROLL`` steps until every hypothesis's last shift is below
    ``stop`` or ``max_iter`` steps have run; ``steps``, a 0-d int32 tensor
    on the inputs' device, counts the steps run."""
    if (points.device.type == "cpu" and mask.device.type == "cpu"
            and win.device.type == "cpu"):
        return shift_to_stop_plain(points, mask, win, bw2, stop, max_iter)
    dev = require_cuda(points, mask, win)
    h, k, _ = points.shape
    if (points.shape[-1] != 3 or mask.shape != (h, k) or win.shape != (h,)
            or h < 1 or k < 1):
        raise ValueError(f"shift_to_stop takes (H, K, 3), (H, K) and (H,) "
                         f"with H, K >= 1, got {tuple(points.shape)}, "
                         f"{tuple(mask.shape)} and {tuple(win.shape)}")
    points = points.float().contiguous()
    mask = mask.bool().contiguous()
    win = win.to(torch.int32).contiguous()
    centres = torch.empty((h, 3), dtype=torch.float32, device=dev)
    steps = torch.empty((), dtype=torch.int32, device=dev)
    with annotate("pvn3d.meanshift.device_loop"):
        KERNEL.launch(dev, points.data_ptr(), mask.data_ptr(),
                      win.data_ptr(), h, k, bw2, stop, max_iter,
                      centres.data_ptr(), steps.data_ptr())
    return centres, steps
