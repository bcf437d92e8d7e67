"""Train-mode BatchNorm (``csrc/bn.cu``): float32 batch statistics, the
normalisation with an optional fused ReLU, and its backward, joined by
``BatchNormTrain`` (a ``torch.autograd.Function``), beside the plain
version of each pass.

Replaces no TPU kernel: the JAX package's BatchNorm
(``pvn3d_tpu/models/layers.py:29-69``) is plain ``jnp`` that XLA fuses into
its neighbours.  In PyTorch the same tensor code (``x.float()``, two means,
the normalisation, the cast, a separate ReLU) is ~30 launches a call, most
of them full float32 passes, and autograd's differentiation of it as many
again, saving float32 copies of the activation.

What it computes is that code's mathematics at its precision: float32
``mean = E[x]`` and ``meansq = E[x^2]`` over every axis but the channel,
``var = max(meansq - mean^2, 0)``, ``y = (x - mean) * (rsqrt(var + eps) *
weight) + bias`` in float32 rounded once to ``x``'s dtype, the running
statistics moved with the per-call momentum and the ``n / (n - 1)``
unbiasing when ``update_running`` is set; with a ``group`` the
``(mean, meansq)`` pair is weighted by 1 / world and summed in one
all-reduce, and ``n`` is the global count.  The backward, with ``g = dy``
masked by the fused ReLU (recomputed from ``x``, so no mask is stored) and
``xh = (x - mean) * rsqrt(var + eps)``: ``dbias = sum g``, ``dweight =
sum g xh`` (this rank's sums), and ``dx = inv * weight * ((g - sum g / n) -
xh * sum g xh / n)`` with both sums all-reduced under a group, the
variance term dropped for a channel whose variance was clamped (the
clamp's gradient).  The forward saves ``x`` and four per-channel float32
rows (mean, rsqrt, scale = rsqrt * weight, the variance flag).

Bound on the card: bytes (6 an element forward in bf16, 10 backward), far
below the ridge.  Three launches a forward (statistics partials, their
fixed-order sum and the parameters, the normalisation), four under a group
(the sum stops at the moments for the all-reduce), three a backward
(gradient-sum partials, their sum, dx).  The grid adapts to what the call
shows: the layout (channels last, NCHW, or an NCHW map in channels_last
memory, which is channels last), the channel count and the row or plane
count, at ~8 blocks of 256 threads per SM (source note in ``bn.cu``).

For CPU tensors each pass runs its plain version (the same formulas,
all-reduces included); for CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pvn3d_tpu_torch.ops.kernels.common import CudaKernel, require_cuda
from pvn3d_tpu_torch.utils.profiling import annotate

ROWS, NCHW = 0, 1
THREADS = 256
# Blocks a pass launches per SM: an SM holds 2048 threads.
BLOCKS_PER_SM = 2048 // THREADS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# dtype, layout, outer, C, inner, vec, tcols, rl, grid x, grid y, threads.
_GRID = [_I, _I, _L, _I, _L, _I, _I, _I, _I, _I, _I]
KERNEL_STATS = CudaKernel("bn_stats", "bn.cu", "bn_stats_launch",
                          [_P] + _GRID + [_P])
KERNEL_FINISH = CudaKernel(
    "bn_finish", "bn.cu", "bn_finish_launch",
    [_P, _I, _I, _F, _F, _P, _I, _P, _F, _P, _P, _F, _F, _F, _I, _P])
KERNEL_APPLY = CudaKernel("bn_apply", "bn.cu", "bn_apply_launch",
                          [_P] + _GRID + [_P, _P, _I, _P])
KERNEL_BWD_REDUCE = CudaKernel("bn_bwd_reduce", "bn.cu",
                               "bn_bwd_reduce_launch",
                               [_P, _P] + _GRID + [_P, _P, _I, _P])
KERNEL_BWD_APPLY = CudaKernel("bn_bwd_apply", "bn.cu", "bn_bwd_apply_launch",
                              [_P, _P] + _GRID + [_P, _P, _I, _P, _F, _P])
KERNELS = (KERNEL_STATS, KERNEL_FINISH, KERNEL_APPLY, KERNEL_BWD_REDUCE,
           KERNEL_BWD_APPLY)


@dataclasses.dataclass(frozen=True)
class Grid:
    """One call's walk: ``layout`` ROWS (``outer`` rows of ``c``) or NCHW
    (``outer`` = N planes of ``inner`` = H*W per channel), the vector width,
    for ROWS the channel groups (``tcols``) and rows (``rl``) a block
    covers, and the launch (``grid_x`` row blocks or plane slices,
    ``grid_y`` channel groups or channels, ``threads``)."""
    layout: int
    outer: int
    c: int
    inner: int
    vec: int
    tcols: int
    rl: int
    grid_x: int
    grid_y: int
    threads: int

    def args(self, dtype: torch.dtype) -> tuple:
        return (_DTYPES[dtype], self.layout, self.outer, self.c, self.inner,
                self.vec, self.tcols, self.rl, self.grid_x, self.grid_y,
                self.threads)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def layout_of(x: torch.Tensor, nchw: bool) -> Tuple[int, int, int, int]:
    """(layout, outer, C, inner) of a train-mode BN input: channels last
    ``(..., C)`` contiguous, or an NCHW map contiguous in either memory
    format; anything else raises."""
    if not nchw:
        if not x.is_contiguous():
            raise ValueError(f"BatchNorm takes a contiguous (..., C) tensor,"
                             f" got strides {x.stride()}")
        c = x.shape[-1]
        return ROWS, x.numel() // max(c, 1), c, 1
    if x.dim() != 4:
        raise ValueError(f"BatchNorm.nchw takes (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.is_contiguous():
        return NCHW, n, c, h * w
    if x.is_contiguous(memory_format=torch.channels_last):
        return ROWS, n * h * w, c, 1
    raise ValueError(f"BatchNorm.nchw takes an NCHW map contiguous in the "
                     f"default or channels_last memory format, got strides "
                     f"{x.stride()}")


def grid(layout: int, outer: int, c: int, inner: int, elem_bytes: int,
         aligned: bool, sms: int) -> Grid:
    """The launch of every pass of one call: 16-byte vectors where the
    channel count (ROWS) or plane length (NCHW) and the pointers allow,
    ``BLOCKS_PER_SM * sms`` blocks or as many as the work fills."""
    vec = 16 // elem_bytes
    target = BLOCKS_PER_SM * sms
    if layout == ROWS:
        if c % vec or not aligned:
            vec = 1
        groups = c // vec
        tcols = min(groups, THREADS)
        gy = -(-groups // tcols)
        rl = THREADS // tcols
        gx = max(1, min(-(-target // gy), -(-outer // rl)))
        return Grid(ROWS, outer, c, 1, vec, tcols, rl, gx, gy, tcols * rl)
    if inner % vec or not aligned:
        vec = 1
    gx = max(1, min(-(-target // c), -(-(outer * inner // vec) // THREADS)))
    return Grid(NCHW, outer, c, inner, vec, 1, 1, gx, c, THREADS)


def _grid_of(x: torch.Tensor, nchw: bool, *others: torch.Tensor) -> Grid:
    layout, outer, c, inner = layout_of(x, nchw)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    return grid(layout, outer, c, inner, x.element_size(), aligned,
                _sms(x.device))


def _per_channel(t: torch.Tensor, nchw: bool) -> torch.Tensor:
    return t[:, None, None] if nchw else t


def _axes(x: torch.Tensor, nchw: bool) -> tuple:
    return (0, 2, 3) if nchw else tuple(range(x.dim() - 1))


def forward_plain(x, weight, bias, running_mean, running_var, nchw: bool,
                  momentum: float, eps: float, relu: bool,
                  update_running: bool, group
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The forward's plain version: (y, the (4, C) statistics, global n)."""
    axes = _axes(x, nchw)
    xf = x.float()
    mean = xf.mean(dim=axes)
    meansq = (xf * xf).mean(dim=axes)
    n = x.numel() // mean.numel()
    if group is not None:
        world = dist.get_world_size(group)
        moments = torch.stack([mean, meansq]) * (1.0 / world)
        dist.all_reduce(moments, group=group)
        mean, meansq = moments.unbind()
        n *= world
    raw = meansq - mean * mean
    var = torch.clamp(raw, min=0.0)
    inv = torch.rsqrt(var + eps)
    # mean, rsqrt, scale, and the flag of a variance the clamp passed.
    st = torch.stack([mean, inv, inv * weight, (raw >= 0).float()])
    if update_running:
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(
            momentum * (var * (n / max(n - 1, 1))))
    y = ((xf - _per_channel(mean, nchw)) * _per_channel(st[2], nchw)
         + _per_channel(bias, nchw)).to(x.dtype)
    return (torch.relu(y) if relu else y), st, n


def backward_plain(x, dy, bias, st, nchw: bool, relu: bool, group, n: int,
                   need_dx: bool = True):
    """The backward's plain version: (dx or None, dweight, dbias), the
    parameter gradients this rank's sums."""
    axes = _axes(x, nchw)
    mean, inv, scale, active = (_per_channel(r, nchw) for r in st)
    xm = x.float() - mean
    g = dy.float()
    if relu:
        y = (xm * scale + _per_channel(bias, nchw)).to(x.dtype)
        g = torch.where(y <= 0, 0.0, g)
    xh = xm * inv
    sums = torch.stack([g.sum(dim=axes), (g * xh).sum(dim=axes)])
    db, dw = sums.unbind()
    if not need_dx:
        return None, dw, db
    if group is not None:
        sums = sums.clone()
        dist.all_reduce(sums, group=group)
    sg, sgx = (_per_channel(r, nchw) for r in sums)
    dx = scale * ((g - sg / n) - xh * (sgx / n * active))
    return dx.to(x.dtype), dw, db


def _check(x, weight, bias, running_mean, running_var, c: int) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"BatchNorm kernels take float32 or bfloat16, got "
                         f"{x.dtype}")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"BatchNorm {name} must be contiguous float32 "
                             f"({c},), got {t.dtype} {tuple(t.shape)}")


def _forward_cuda(x, weight, bias, running_mean, running_var, nchw: bool,
                  momentum: float, eps: float, relu: bool,
                  update_running: bool, group):
    dev = require_cuda(x, weight, bias, running_mean, running_var)
    g = _grid_of(x, nchw)
    c = g.c
    _check(x, weight, bias, running_mean, running_var, c)
    part = torch.empty((g.grid_x, 2, c), dtype=torch.float32, device=dev)
    KERNEL_STATS.launch(dev, x.data_ptr(), *g.args(x.dtype), part.data_ptr())
    world = 1 if group is None else dist.get_world_size(group)
    n_local = x.numel() // c
    n = n_local * world
    moments = torch.empty((2, c), dtype=torch.float32, device=dev)
    st = torch.empty((4, c), dtype=torch.float32, device=dev)
    tail = (weight.data_ptr(), eps, running_mean.data_ptr(),
            running_var.data_ptr(), 1.0 - momentum, momentum,
            n / max(n - 1, 1), int(update_running), st.data_ptr())
    if group is None:
        KERNEL_FINISH.launch(dev, part.data_ptr(), g.grid_x, c,
                             float(n_local), 1.0, moments.data_ptr(), 1,
                             *tail)
    else:
        KERNEL_FINISH.launch(dev, part.data_ptr(), g.grid_x, c,
                             float(n_local), 1.0 / world, moments.data_ptr(),
                             0, *tail)
        dist.all_reduce(moments, group=group)
        KERNEL_FINISH.launch(dev, None, 0, c, 1.0, 1.0, moments.data_ptr(), 1,
                             *tail)
    y = torch.empty_like(x)
    KERNEL_APPLY.launch(dev, x.data_ptr(), *g.args(x.dtype), st.data_ptr(),
                        bias.data_ptr(), int(relu), y.data_ptr())
    return y, st, n


def _backward_cuda(x, dy, bias, st, nchw: bool, relu: bool, group, n: int,
                   need_dx: bool = True):
    dev = require_cuda(x, dy, bias, st)
    if dy.dtype != x.dtype or dy.stride() != x.stride():
        # Autograd may hand over another layout: take x's.
        dy = torch.empty_like(x).copy_(dy)
    g = _grid_of(x, nchw, dy)
    c = g.c
    part = torch.empty((g.grid_x, 2, c), dtype=torch.float32, device=dev)
    KERNEL_BWD_REDUCE.launch(dev, x.data_ptr(), dy.data_ptr(),
                             *g.args(x.dtype), st.data_ptr(),
                             bias.data_ptr(), int(relu), part.data_ptr())
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    KERNEL_FINISH.launch(dev, part.data_ptr(), g.grid_x, c, 1.0, 1.0,
                         sums.data_ptr(), 0, None, 0.0, None, None, 0.0, 0.0,
                         0.0, 0, None)
    db, dw = sums.unbind()
    if not need_dx:
        return None, dw, db
    if group is not None:
        sums = sums.clone()
        dist.all_reduce(sums, group=group)
    dx = torch.empty_like(x)
    KERNEL_BWD_APPLY.launch(dev, x.data_ptr(), dy.data_ptr(),
                            *g.args(x.dtype), st.data_ptr(), bias.data_ptr(),
                            int(relu), sums.data_ptr(), float(n),
                            dx.data_ptr())
    return dx, dw, db


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm forward and backward as one differentiable
    function; ``weight`` and ``bias`` get this rank's gradients, the
    running statistics none (they move in place in the forward)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, nchw,
                momentum, eps, relu, update_running, group):
        fwd = (forward_plain if _on_cpu(x, weight, bias, running_mean,
                                        running_var) else _forward_cuda)
        y, st, n = fwd(x, weight, bias, running_mean, running_var, nchw,
                       momentum, eps, relu, update_running, group)
        ctx.save_for_backward(x, bias, st)
        ctx.nchw, ctx.relu, ctx.group, ctx.n = nchw, relu, group, n
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, bias, st = ctx.saved_tensors
        with annotate("pvn3d.batchnorm_backward"):
            bwd = backward_plain if _on_cpu(x, dy) else _backward_cuda
            dx, dw, db = bwd(x, dy, bias, st, ctx.nchw, ctx.relu, ctx.group,
                             ctx.n, ctx.needs_input_grad[0])
        need = ctx.needs_input_grad
        return ((dx, dw if need[1] else None, db if need[2] else None)
                + (None,) * 8)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, *, nchw: bool,
                     momentum: float, eps: float, relu: bool = False,
                     update_running: bool = True,
                     group: Optional[object] = None) -> torch.Tensor:
    """Train-mode BN of ``x`` (channels last ``(..., C)``, or NCHW with
    ``nchw``) by its batch statistics, then ReLU when ``relu``; the
    running statistics move in place when ``update_running``; ``group``
    makes the statistics global over a process group."""
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                nchw, float(momentum), float(eps), relu,
                                update_running, group)
