"""RandLA-Net, FFB6D's point branch (eval and train mode), channels last.

Port of ethnhe/FFB6D ``models/RandLA/RandLANet.py`` (Hu et al., CVPR 2020)
as FFB6D runs it: ``fc0``, four dilated residual blocks (each a local
spatial encoding and two attentive poolings over the k nearest
neighbours), random sampling as a gather + max over the kept points'
neighbourhoods, nearest interpolation, and the decoder convs.  Every conv
is a bias-free 1x1 + BN + LeakyReLU(0.2), the default of the RandLA
``pytorch_utils.Conv2d`` that FFB6D carries, unless marked otherwise.
Points are (B, N, C); the neighbour indices come from
``data/ffb6d_index.py``.  Features compute in the input's dtype; the
coordinates of the local spatial encoding stay float32 until the 10
channels are made.  In train mode every BN takes the momentum the caller
passes per call (``models/layers.py::BatchNorm``).

Where a gradient is recorded, ``gather_rows`` is ``GatherRows``: one
``index_select`` of rows of the flattened (B*N, C) table forward, and a
scatter-add of the row gradients back into it (``index_add_``, summed in
float32) in the backward, inside a ``pvn3d.gather_backward`` range on
autograd's thread.  Without a gradient (serving) it is a plain gather.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.config import RandLAConfig
from pvn3d_tpu_torch.models.layers import BatchNorm, linear
from pvn3d_tpu_torch.utils.profiling import annotate


class ConvBNAct(nn.Module):
    """``pytorch_utils.Conv2d(c_in, c_out, kernel_size=(1, 1), bn=True)``:
    a bias-free 1x1 conv, BN and LeakyReLU(``slope``), or no activation
    (``act=False``), on channels-last rows.  Keys ``conv.weight`` and
    ``bn.*``."""

    def __init__(self, c_in: int, c_out: int, act: bool = True,
                 slope: float = 0.2):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.bn = BatchNorm(c_out)
        self.act = act
        self.slope = slope

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        return self.finish(linear(x, self.conv.weight), bn_momentum)

    def finish(self, y: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """BN and the activation of the pre-activation ``y``."""
        y = self.bn(y, bn_momentum)
        return F.leaky_relu(y, self.slope) if self.act else y

    def split(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """``x`` times input channels ``lo .. hi`` of the weight: one block
        of the product of a concatenated input."""
        w = self.conv.weight
        return F.linear(x, w.reshape(w.shape[0], w.shape[1])[:, lo:hi]
                        .to(x.dtype))


class GatherRows(torch.autograd.Function):
    """Rows ``rows`` (flat indices into the (B*N, C) table of (B, N, C)
    ``feats``) -> (len(rows), C); the backward sums each row's gradient
    into its source row (``index_add_`` in float32, or float64 for a
    float64 gradient; one rounding to the gradient's dtype), inside ``pvn3d.gather_backward``."""

    @staticmethod
    def forward(ctx, feats: torch.Tensor, rows: torch.Tensor
                ) -> torch.Tensor:
        b, n, c = feats.shape
        ctx.shape = (b, n, c)
        ctx.save_for_backward(rows)
        return feats.reshape(b * n, c).index_select(0, rows)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (rows,) = ctx.saved_tensors
        b, n, c = ctx.shape
        with annotate("pvn3d.gather_backward"):
            acc = torch.promote_types(grad.dtype, torch.float32)
            table = torch.zeros((b * n, c), dtype=acc, device=grad.device)
            table.index_add_(0, rows, grad.reshape(-1, c).to(acc))
            return table.to(grad.dtype).reshape(b, n, c), None


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, C) ``feats`` at (B, ...) indices -> (B, ..., C);
    through ``GatherRows`` where a gradient is recorded for ``feats``."""
    b, n, c = feats.shape
    flat = idx.reshape(b, -1)
    if feats.requires_grad and torch.is_grad_enabled():
        rows = flat.long() + n * torch.arange(b, device=feats.device)[:, None]
        out = GatherRows.apply(feats, rows.reshape(-1))
    elif b == 1:
        out = feats[0].index_select(0, flat[0])[None]
    else:
        out = feats[torch.arange(b, device=feats.device)[:, None],
                    flat.long()]
    return out.reshape(*idx.shape, c)


def random_sample(feats: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """(B, N, C) and the kept points' neighbourhoods (B, M, k) -> the max
    over each neighbourhood (B, M, C) (``FFB6D.random_sample``)."""
    return gather_rows(feats, sub).amax(dim=2)


def nearest_interpolation(feats: torch.Tensor, interp: torch.Tensor
                          ) -> torch.Tensor:
    """(B, M, C) and each finer point's nearest coarse point (B, N) ->
    (B, N, C) (``FFB6D.nearest_interpolation``)."""
    return gather_rows(feats, interp)


def relative_pos_encoding(xyz: torch.Tensor, nei: torch.Tensor
                          ) -> torch.Tensor:
    """(B, N, 3) float32 points and (B, N, k) neighbours -> (B, N, k, 10)
    ``[|p_i - p_k|, p_i - p_k, p_i, p_k]``."""
    nxyz = gather_rows(xyz, nei)
    tile = xyz[:, :, None, :].expand_as(nxyz)
    rel = tile - nxyz
    dis = torch.sqrt((rel * rel).sum(dim=-1, keepdim=True))
    return torch.cat([dis, rel, tile, nxyz], dim=-1)


class AttPooling(nn.Module):
    """``Att_pooling``: scores ``softmax_k(W x)`` (W a bias-free d_in x
    d_in 1x1), the score-weighted sum over k, then a conv d_in -> d_out."""

    def __init__(self, d_in: int, d_out: int, slope: float):
        super().__init__()
        self.fc = nn.Conv2d(d_in, d_in, 1, bias=False)
        self.mlp = ConvBNAct(d_in, d_out, slope=slope)

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """(B, N, k, d_in) -> (B, N, d_out)."""
        scores = torch.softmax(linear(x, self.fc.weight), dim=2)
        return self.mlp((x * scores).sum(dim=2), bn_momentum)


class BuildingBlock(nn.Module):
    """``Building_block``: local spatial encoding and two attentive
    poolings, d_out / 2 -> d_out channels."""

    def __init__(self, d_out: int, slope: float):
        super().__init__()
        self.mlp1 = ConvBNAct(10, d_out // 2, slope=slope)
        self.att_pooling_1 = AttPooling(d_out, d_out // 2, slope)
        self.mlp2 = ConvBNAct(d_out // 2, d_out // 2, slope=slope)
        self.att_pooling_2 = AttPooling(d_out, d_out, slope)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                nei: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        f_xyz = self.mlp1(relative_pos_encoding(xyz, nei).to(feats.dtype),
                          bn_momentum)
        agg = self.att_pooling_1(torch.cat([gather_rows(feats, nei), f_xyz],
                                           dim=-1), bn_momentum)
        f_xyz = self.mlp2(f_xyz, bn_momentum)
        return self.att_pooling_2(torch.cat([gather_rows(agg, nei), f_xyz],
                                            dim=-1), bn_momentum)


class DilatedResBlock(nn.Module):
    """``Dilated_res_block``: mlp1, the building block, mlp2 (no
    activation) plus a shortcut conv (no activation), LeakyReLU."""

    def __init__(self, d_in: int, d_out: int, slope: float):
        super().__init__()
        self.slope = slope
        self.mlp1 = ConvBNAct(d_in, d_out // 2, slope=slope)
        self.lfa = BuildingBlock(d_out, slope)
        self.mlp2 = ConvBNAct(d_out, 2 * d_out, act=False)
        self.shortcut = ConvBNAct(d_in, 2 * d_out, act=False)

    def forward(self, feats: torch.Tensor, xyz: torch.Tensor,
                nei: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        f = self.lfa(xyz, self.mlp1(feats, bn_momentum), nei, bn_momentum)
        f = self.mlp2(f, bn_momentum)
        return F.leaky_relu(f + self.shortcut(feats, bn_momentum),
                            self.slope)


def decoder_inputs(cfg: RandLAConfig) -> List[int]:
    """Each decoder conv's input width: the skip (the first block's
    output, then each encoder stage's fused points, deepest first) plus
    the interpolated deeper features."""
    skips = [2 * cfg.d_out[0]] + [2 * d for d in cfg.d_out]
    prev = 2 * cfg.d_out[-1]
    widths = []
    for j, w in enumerate(cfg.decoder_widths):
        widths.append(skips[-j - 2] + prev)
        prev = w
    return widths


class RandLANet(nn.Module):
    """The modules FFB6D takes from RandLA-Net: ``fc0``,
    ``dilated_res_blocks`` and ``decoder_blocks``; FFB6D's forward
    interleaves them with its fusion."""

    def __init__(self, cfg: RandLAConfig):
        super().__init__()
        slope = cfg.leaky_slope
        self.fc0 = ConvBNAct(cfg.in_channels, cfg.fc0_width, slope=slope)
        self.dilated_res_blocks = nn.ModuleList()
        d_in = cfg.fc0_width
        for d_out in cfg.d_out:
            self.dilated_res_blocks.append(DilatedResBlock(d_in, d_out,
                                                           slope))
            d_in = 2 * d_out
        self.decoder_blocks = nn.ModuleList([
            ConvBNAct(c_in, c_out, slope=slope)
            for c_in, c_out in zip(decoder_inputs(cfg), cfg.decoder_widths)])
