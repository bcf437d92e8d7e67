"""Shared building blocks of the port (eval and train mode).

Port of the JAX package's ``models/layers.py``.  The point branch and the
heads keep channels last (``(..., C)``) as the JAX package does; the image
branch runs NCHW for cuDNN and converts at its ends.  Parameters carry the
shapes and names of the reference PyTorch checkpoint (``conv.weight``
``(O, I, 1[, 1])``, BN ``weight/bias/running_mean/running_var``), so
``state_dict`` keys are the reference keys.

Every module computes in ``dtype`` (float32 or bfloat16) with float32
parameters and float32 BN statistics, as the JAX package does.  In train
mode (``module.train()``) every BN normalises by its batch statistics and
moves its running ones with the momentum the caller passes per call, so
the BN-momentum schedule is an argument of the forward, not module state.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.ops.kernels.bn import batch_norm_train
from pvn3d_tpu_torch.utils.profiling import annotate


def _train_span(fn):
    """``pvn3d.bn`` around each train-mode call of the method ``fn`` (the
    normalisation and the fused ReLU)."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if not self.training:
            return fn(self, *args, **kwargs)
        with annotate("pvn3d.bn"):
            return fn(self, *args, **kwargs)
    return wrapped


class BatchNorm(nn.BatchNorm2d):
    """Batch norm over the LAST axis with float32 statistics:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast
    back to the input dtype (``layers.py:29-69`` of the JAX package);
    ``relu=True`` applies a ReLU after it (the callers whose BN a ReLU
    follows pass it, so train mode fuses it into the normalisation).

    Eval mode reads the running statistics, in plain tensor code.  Train
    mode takes the batch mean and the biased ``E[x^2] - E[x]^2`` (clamped
    at 0: it can round negative for a large-mean, low-variance channel)
    over every axis but the channel, normalises by them, and updates the
    running statistics with the torch-convention ``momentum`` passed per
    call: ``running <- (1 - m) * running + m * batch``, the running
    variance unbiased by ``n / (n - 1)``.  It runs as one autograd
    function (``ops/kernels/bn.py::batch_norm_train``): the hand-written
    kernel pair on the card, its plain version on the CPU.

    ``process_group`` (set by the train step under a data-parallel mesh)
    makes the statistics global, as JAX's batch-axis mean over a
    dp-sharded batch is: every rank's ``E[x]`` and ``E[x^2]``, weighted by
    1 / world (ranks hold equal rows), are summed over the group in one
    all-reduce, the backward's two channel sums in another, and ``n`` is
    the global count.  At world 1 the weight is 1.0 and the result is bit
    for bit the local one.  ``update_running`` False (a rematerialised
    forward) leaves the running statistics where the first forward put
    them.
    """

    process_group = None
    update_running = True

    def _normalise(self, x: torch.Tensor, nchw: bool, momentum,
                   relu: bool) -> torch.Tensor:
        if self.training:
            return batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, nchw=nchw, momentum=momentum,
                eps=self.eps, relu=relu, update_running=self.update_running,
                group=self.process_group)
        mean, bias = self.running_mean, self.bias
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        if nchw:
            mean, inv, bias = (t[:, None, None] for t in (mean, inv, bias))
        y = ((x.float() - mean) * inv + bias).to(x.dtype)
        return F.relu(y) if relu else y

    @_train_span
    def forward(self, x: torch.Tensor, momentum=0.1,
                relu: bool = False) -> torch.Tensor:
        return self._normalise(x, False, momentum, relu)

    @_train_span
    def nchw(self, x: torch.Tensor, momentum=0.1,
             relu: bool = False) -> torch.Tensor:
        """The same normalisation over axis 1 of an NCHW map (contiguous
        in the default or the channels_last memory format)."""
        return self._normalise(x, True, momentum, relu)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """A 1x1 conv weight ``(O, I, 1[, 1])`` applied to channels-last
    ``x (..., I)`` in ``x.dtype``."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


class Conv1x1BN(nn.Module):
    """``conv`` (bias-free 1x1) + ``normlayer.bn`` + ReLU: one reference
    etw ``SharedMLP`` layer (etw_pytorch_utils/pytorch_utils.py:25-50) or
    one hidden layer of a head."""

    def __init__(self, c_in: int, c_out: int, conv_dims: int = 2):
        super().__init__()
        self.conv = (nn.Conv2d(c_in, c_out, 1, bias=False) if conv_dims == 2
                     else nn.Conv1d(c_in, c_out, 1, bias=False))
        self.normlayer = nn.Module()
        self.normlayer.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        return self.finish(linear(x, self.conv.weight), bn_momentum)

    def finish(self, y: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """BN + ReLU of the pre-activation ``y`` (``x`` times the conv
        weight, however the caller contracted it)."""
        return self.normlayer.bn(y, bn_momentum, relu=True)


class SharedMLP(nn.Module):
    """Per-point Dense + BN + ReLU stack on the trailing axis; keys
    ``layer{k}.conv.weight`` / ``layer{k}.normlayer.bn.*``.

    ``precompute_first`` / ``precompute_leading`` and the
    ``first_precomputed`` argument are the JAX package's eval
    restructures (``layers.py:137-176``): layer 0's input is a concat of
    two blocks, so its product splits as ``x_a @ K[a] + x_b @ K[b]``; the
    caller contracts one block before a gather or an interpolation (on
    fewer rows) and passes the result in, and ``x`` then carries the
    other block, starting at channel ``x_offset`` of layer 0's input."""

    def __init__(self, c_in: int, widths: Sequence[int]):
        super().__init__()
        for k, w in enumerate(widths):
            self.add_module(f"layer{k}", Conv1x1BN(c_in, w))
            c_in = w
        self.n_layers = len(widths)

    def _k0(self) -> torch.Tensor:
        """Layer 0's weight as ``(O, I)``: ``K0`` transposed."""
        w = self.layer0.conv.weight
        return w.reshape(w.shape[0], w.shape[1])

    def forward(self, x: torch.Tensor, bn_momentum=0.1,
                first_precomputed: torch.Tensor | None = None,
                x_offset: int = 0) -> torch.Tensor:
        """``first_precomputed``: the already contracted part of layer 0,
        ``(..., widths[0])`` in ``x.dtype``; ``x`` is then the rest of
        layer 0's input, channels ``x_offset .. x_offset + x.shape[-1]``."""
        for k in range(self.n_layers):
            layer = getattr(self, f"layer{k}")
            if k == 0 and first_precomputed is not None:
                a = x.shape[-1]
                w = self._k0()[:, x_offset:x_offset + a].to(x.dtype)
                x = layer.finish(F.linear(x, w)
                                 + first_precomputed.to(x.dtype), bn_momentum)
            else:
                x = layer(x, bn_momentum)
        return x

    def precompute_first(self, feats: torch.Tensor, n_lead: int,
                         dtype: torch.dtype) -> torch.Tensor:
        """``feats @ K0[n_lead:]`` in ``dtype``: layer 0's trailing
        block (the SA restructure: per source point, before the
        neighbourhood gather)."""
        return F.linear(feats.to(dtype), self._k0()[:, n_lead:].to(dtype))

    def precompute_leading(self, feats: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
        """``feats @ K0[:C]`` in ``dtype``, C = ``feats.shape[-1]``: layer
        0's leading block (the FP restructure: IDW interpolation is a
        pointwise blend, so it commutes with the product, which then runs
        on the m known rows instead of the n interpolated ones)."""
        return F.linear(feats.to(dtype),
                        self._k0()[:, :feats.shape[-1]].to(dtype))


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in ``x.dtype`` (its float32 weights cast)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Elementwise dropout (``flax.linen.Dropout``, not ``Dropout2d``):
    in train mode each element is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; the mask is drawn from ``generator`` (on
    ``x``'s device), or from the default generator when it is None.  Eval
    mode draws nothing."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return x * (mask.to(x.dtype) / keep)


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope (torch init 0.25)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def named_sequential(**modules: nn.Module) -> nn.Sequential:
    """An ``nn.Sequential`` whose children carry the given names (the
    reference's ``Sequential`` indices, e.g. ``conv.1`` / ``conv.2``)."""
    return nn.Sequential(OrderedDict(modules))


def _resize_matrix(src: int, dst: int, align_corners: bool) -> np.ndarray:
    """(dst, src) bilinear interpolation weights, torch semantics."""
    if dst == src:
        return np.eye(dst, dtype=np.float32)
    out = np.zeros((dst, src), np.float32)
    for i in range(dst):
        if align_corners:
            pos = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        else:
            pos = (i + 0.5) * src / dst - 0.5
        pos = min(max(pos, 0.0), src - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, src - 1)
        frac = pos - lo
        out[i, lo] += 1.0 - frac
        out[i, hi] += frac
    return out


def shifted_resize_matrix(src: int, dst: int,
                          align_corners: bool) -> np.ndarray:
    """(dst, 3*src) stacked bilinear matrices for resize-into-conv fusion
    (``layers.py:279`` of the JAX package).

    Column block ``i`` (the conv tap, 0..2) holds the resize matrix with
    its rows shifted by ``i - 1``: ``out[r, i*src + j] = R[r + i - 1, j]``
    for the plain (dst, src) matrix ``R``, rows outside ``[0, dst)`` zero
    (the conv's zero padding of the resized map).  Applied to
    tap-contracted features it computes ``sum_i shift_{i-1}(resize(z_i))``
    in one matmul (``models/pspnet.py::PSPUpsample.fused``)."""
    r = _resize_matrix(src, dst, align_corners)
    out = np.zeros((dst, 3 * src), np.float32)
    for i in range(3):
        d = i - 1
        lo = max(0, -d)
        hi = min(dst, dst - d)
        out[lo:hi, i * src:(i + 1) * src] = r[lo + d:hi + d]
    return out


def _adaptive_pool_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) averaging weights with torch AdaptiveAvgPool2d bins."""
    out = np.zeros((dst, src), np.float32)
    for i in range(dst):
        lo = (i * src) // dst
        hi = -((-(i + 1) * src) // dst)  # ceil
        out[i, lo:hi] = 1.0 / (hi - lo)
    return out


_SEPARABLE = {"resize": _resize_matrix,
              "shifted": shifted_resize_matrix,
              "pool": lambda src, dst, _: _adaptive_pool_matrix(src, dst)}


@functools.lru_cache(maxsize=None)
def separable_tensor(kind: str, src: int, dst: int, align_corners: bool,
                     dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The matrix of one axis of a separable map as a tensor of ``dtype``
    on ``device``, built once per key: ``kind`` "resize"
    (``_resize_matrix``, (dst, src)), "shifted"
    (``shifted_resize_matrix``, (dst, 3 src)) or "pool"
    (``_adaptive_pool_matrix``, (dst, src); ``align_corners`` unused).  A
    forward copies no host matrix, so it waits for no queue and can be
    captured in a CUDA graph.  Made outside inference mode, so a later
    forward that records a graph may use it too."""
    m = _SEPARABLE[kind](src, dst, align_corners)
    with torch.inference_mode(False):
        return torch.as_tensor(m, device=device).to(dtype)


def _separable(x: torch.Tensor, kind: str, out_h: int, out_w: int,
               align_corners: bool, channels_last: bool) -> torch.Tensor:
    h, w = (x.shape[-3], x.shape[-2]) if channels_last else x.shape[-2:]
    wh_t = separable_tensor(kind, h, out_h, align_corners, x.dtype, x.device)
    ww_t = separable_tensor(kind, w, out_w, align_corners, x.dtype, x.device)
    if channels_last:
        x = torch.einsum("oh,...hwc->...owc", wh_t, x)
        return torch.einsum("ow,...hwc->...hoc", ww_t, x)
    x = torch.einsum("oh,...hw->...ow", wh_t, x)
    return torch.einsum("ow,...hw->...ho", ww_t, x)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False,
                    channels_last: bool = True) -> torch.Tensor:
    """Separable bilinear resize of ``(..., H, W, C)`` (or ``(..., H, W)``
    with ``channels_last=False``) as two static-weight matmuls: the JAX
    package's ``method="matmul"`` (``layers.py:179-277``), torch's
    align-corners semantics."""
    return _separable(x, "resize", out_h, out_w, align_corners,
                      channels_last)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int,
                      channels_last: bool = True) -> torch.Tensor:
    """Adaptive average pooling with torch's bins, as two matmuls
    (``layers.py:301-318`` of the JAX package)."""
    return _separable(x, "pool", out_h, out_w, False, channels_last)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with pad 1 on NCHW (resnet stem)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)
