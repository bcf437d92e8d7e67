"""PSPNet image branch: trunk -> pyramid pooling -> 3x upsample -> heads.

Port of the JAX package's ``models/pspnet.py``: the reference
Modified_PSPNet (pspnet.py:7-90), with the JAX package's two eval
restructures, which share the dense graph's parameters:

* ``PSPUpsample.fused`` (``fuse_up``, the config's ``fuse_upsample``):
  the 2x resize folded around the nine-tap matmul, so the channel
  contraction runs at the low resolution; every upsample stage but the
  last takes it in eval mode (JAX ``:94-129``, ``:262-266``).
* ``PSPUpsample.sparse`` and ``forward(choose=...)``: the last stage and
  both 1x1 heads only at the chosen full-resolution pixels, from one 3x3
  source patch a pixel (JAX ``:131-205``, ``:268-294``).

Train mode (``module.train()``) takes the dense path, with
batch-statistics BN and the two elementwise dropouts of the JAX package
(``dropout_psp`` after the pyramid, ``dropout_up`` after the first two
upsamples).  Runs NCHW inside; its interface is channels-last like the
JAX package's.  Module names give the reference checkpoint's
``cnn.model.*`` keys (``psp.stages.{i}.1``, ``up_{k}.conv.{1,2,3}``,
``final.0``, ``final_seg.0``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.models.layers import (BatchNorm, PReLU,
                                           adaptive_avg_pool, conv2d,
                                           dropout, linear,
                                           named_sequential,
                                           resize_bilinear,
                                           separable_tensor)
from pvn3d_tpu_torch.models.resnet import DilatedResNet
from pvn3d_tpu_torch.utils.graphs import Graphed


class PSPModule(nn.Module):
    """Pyramid pooling: pool to s x s, 1x1 conv, resize back, concat,
    bottleneck (pspnet.py:7-31).  NCHW in and out."""

    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        self.stages = nn.ModuleList([
            named_sequential(**{"1": nn.Conv2d(features, features, 1,
                                               bias=False)})
            for _ in self.sizes])
        self.bottleneck = nn.Conv2d(features * (len(self.sizes) + 1),
                                    out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        priors = []
        for s, stage in zip(self.sizes, self.stages):
            p = adaptive_avg_pool(x, s, s, channels_last=False)
            p = conv2d(p, stage[0])
            priors.append(resize_bilinear(p, h, w, align_corners=False,
                                          channels_last=False))
        priors.append(x)
        return F.relu(conv2d(torch.cat(priors, dim=1), self.bottleneck))


class PSPUpsample(nn.Module):
    """2x bilinear (align_corners) + 3x3 conv + BN + PReLU
    (pspnet.py:34-45).  NCHW in and out."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv = named_sequential(**{
            "1": nn.Conv2d(c_in, features, 3, padding=1),
            "2": BatchNorm(features),
            "3": PReLU()})

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = resize_bilinear(x, 2 * h, 2 * w, align_corners=True,
                            channels_last=False)
        x = self.conv[1].nchw(conv2d(x, self.conv[0]), bn_momentum)
        return self.conv[2](x)

    def fused(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """The same stage with the resize folded around the conv (NCHW in
        and out): with ``z_ij = x @ W[i, j]`` (the nine taps as one
        ``(Cin, 9 Co)`` product at the input's resolution) and the resize
        the separable map ``R_h x R_w^T``, the conv output is
        ``y[r, c] = sum_ij (R_h z_ij R_w^T)[r + i - 1, c + j - 1]``, the
        out-of-range rows and columns zero; each spatial sum is one matmul
        against ``shifted_resize_matrix``.  Equal to ``forward`` up to
        summation order."""
        b, cin, h, w = x.shape
        conv = self.conv[0]
        co = conv.weight.shape[0]
        dt = x.dtype
        k = conv.weight.permute(1, 2, 3, 0).reshape(cin, 9 * co).to(dt)
        z = (x.permute(0, 2, 3, 1) @ k).reshape(b, h, w, 3, 3, co)
        rh3 = separable_tensor("shifted", h, 2 * h, True, dt, x.device)
        rw3 = separable_tensor("shifted", w, 2 * w, True, dt, x.device)
        # H pass over the stacked (tap i, h) axis.
        z = z.permute(0, 3, 1, 2, 4, 5).reshape(b, 3 * h, w * 3 * co)
        t = (rh3 @ z).reshape(b, 2 * h, w, 3, co)
        # W pass over the stacked (tap j, w) axis.
        t = t.permute(0, 1, 3, 2, 4).reshape(b, 2 * h, 3 * w, co)
        y = rw3 @ t + conv.bias.to(dt)                 # (B, 2H, 2W, Co)
        return self.conv[2](self.conv[1](y, bn_momentum)).permute(0, 3, 1, 2)

    def sparse(self, x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               bn_momentum=0.1) -> torch.Tensor:
        """The stage at output pixels ``(rows, cols)`` only: NCHW
        ``(B, C, H, W)`` and ``(B, P)`` int32 -> ``(B, P, features)``.

        The 3x3 conv input patch of each pixel is sampled bilinearly from
        the virtual ``(2H, 2W)`` upsampled map; taps outside it are zero
        (the conv's padding).  The nine taps' 2x2 corners all lie in one
        3x3 source patch anchored at the first tap's floor (consecutive
        taps advance the source coordinate by ``2(h-1)/(2h-1) < 1``, and
        the clip folds the ``h-1`` edge into the same rows), so: nine
        gathers for the patch, per-tap corners as 2-way selects on the
        0/1 floor offsets, the lerp fractions rounded to ``x.dtype`` and
        the lerp in it, as the JAX package does; then the conv at the
        patch centre as one ``(B P, 9 C) @ (9 C, Co)`` product."""
        b, c, h, w = x.shape
        oh, ow = 2 * h, 2 * w
        flat = x.permute(0, 2, 3, 1).reshape(b, h * w, c)

        def axis_info(base, d, src, dst):
            t = base + d
            inside = (t >= 0) & (t < dst)
            f = (torch.clamp(t, 0, dst - 1).float()
                 * ((src - 1) / max(dst - 1, 1)))
            i0 = torch.clamp(torch.floor(f).int(), 0, src - 1)
            return inside, f, i0

        r_info = [axis_info(rows, d, h, oh) for d in (-1, 0, 1)]
        c_info = [axis_info(cols, d, w, ow) for d in (-1, 0, 1)]
        row0, col0 = r_info[0][2], c_info[0][2]       # smallest floors
        pr = [torch.clamp(row0 + i, max=h - 1) for i in range(3)]
        pc = [torch.clamp(col0 + j, max=w - 1) for j in range(3)]

        def gather(i, j):
            idx = (pr[i] * w + pc[j]).long()[..., None].expand(-1, -1, c)
            return torch.gather(flat, 1, idx)          # (B, P, C)
        patch = [[gather(i, j) for j in range(3)] for i in range(3)]

        def corner(i, j, offr, offc):
            # patch[offr + i][offc + j] with offr, offc in {0, 1}.
            top = torch.where(offc, patch[i][j + 1], patch[i][j])
            bot = torch.where(offc, patch[i + 1][j + 1], patch[i + 1][j])
            return torch.where(offr, bot, top)

        taps = []
        for rin, rf, r0 in r_info:
            offr = (r0 - row0)[..., None] != 0
            rfr = (rf - r0.float()).to(x.dtype)[..., None]
            for cin_, cf, c0 in c_info:
                offc = (c0 - col0)[..., None] != 0
                cfr = (cf - c0.float()).to(x.dtype)[..., None]
                top = (corner(0, 0, offr, offc) * (1 - cfr)
                       + corner(0, 1, offr, offc) * cfr)
                bot = (corner(1, 0, offr, offc) * (1 - cfr)
                       + corner(1, 1, offr, offc) * cfr)
                v = top * (1 - rfr) + bot * rfr
                taps.append(torch.where((rin & cin_)[..., None], v, 0))
        p = rows.shape[1]
        patch9 = torch.stack(taps, dim=2).reshape(b * p, 9 * c)
        conv = self.conv[0]
        co = conv.weight.shape[0]
        k = conv.weight.permute(2, 3, 1, 0).reshape(9 * c, co).to(x.dtype)
        y = (patch9 @ k + conv.bias.to(x.dtype)).reshape(b, p, co)
        return self.conv[2](self.conv[1](y, bn_momentum))


class PSPNetEmbedding(Graphed):
    """Full image branch.  ``forward(rgb (B, H, W, 3))`` returns the
    per-pixel embedding ``(B, H, W, embedding_dim)`` and the auxiliary
    log-softmax seg map ``(B, H, W, n_classes)``, channels-last; with
    ``choose`` (B, P) flat full-resolution pixel indices, the last stage
    and the heads run at those pixels only and both come as (B, P, .).
    ``fuse_up`` runs the upsample stages but the last through
    ``PSPUpsample.fused`` in eval mode.  On the card in eval mode with
    autograd off the forward replays a CUDA graph, one per input
    signature and tail (``utils/graphs.py``)."""

    def __init__(self, n_classes: int = 22, sizes: Sequence[int] = (1, 2, 3, 6),
                 psp_features: int = 512, psp_out: int = 1024,
                 up_channels: Sequence[int] = (256, 64, 64),
                 embedding_dim: int = 128,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 dropout_psp: float = 0.3, dropout_up: float = 0.15,
                 fuse_up: bool = False):
        super().__init__()
        self.dropout_psp = dropout_psp
        self.dropout_up = dropout_up
        self.fuse_up = fuse_up
        self.feats = DilatedResNet(layers=backbone_layers)
        self.psp = PSPModule(psp_features, psp_out, sizes)
        c = psp_out
        self.n_up = len(up_channels)
        for k, ch in enumerate(up_channels, start=1):
            self.add_module(f"up_{k}", PSPUpsample(c, ch))
            c = ch
        self.final = named_sequential(**{"0": nn.Conv2d(c, embedding_dim, 1)})
        self.final_seg = named_sequential(**{"0": nn.Conv2d(c, n_classes, 1)})

    def forward(self, rgb: torch.Tensor, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None,
                choose: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if choose is None:
            return self.graphed(
                ("dense",), lambda x: self._forward(x, bn_momentum,
                                                    generator), rgb)
        return self.graphed(
            ("sparse",), lambda x, c: self._forward(x, bn_momentum,
                                                    generator, c),
            rgb, choose)

    def _forward(self, rgb: torch.Tensor, bn_momentum=0.1,
                 generator: Optional[torch.Generator] = None,
                 choose: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.feats(rgb.permute(0, 3, 1, 2), bn_momentum)
        x = dropout(self.psp(x), self.dropout_psp, self.training, generator)
        fuse = self.fuse_up and not self.training
        for k in range(1, self.n_up):
            up = getattr(self, f"up_{k}")
            x = up.fused(x, bn_momentum) if fuse else up(x, bn_momentum)
            x = dropout(x, self.dropout_up, self.training, generator)
        last = getattr(self, f"up_{self.n_up}")
        if choose is None:
            # The last stage is never fused (JAX :262-266).
            x = last(x, bn_momentum)
            emb = conv2d(x, self.final[0]).permute(0, 2, 3, 1)
            seg = conv2d(x, self.final_seg[0]).permute(0, 2, 3, 1)
            return emb, F.log_softmax(seg.float(), dim=-1)
        out_w = 2 * x.shape[-1]
        choose = choose.int()
        pts = last.sparse(x, choose // out_w, choose % out_w, bn_momentum)
        # final_seg runs at the points too, as in the JAX package: its
        # log-probs are (B, P, n_classes).
        emb = linear(pts, self.final[0].weight, self.final[0].bias)
        seg = linear(pts, self.final_seg[0].weight, self.final_seg[0].bias)
        return emb, F.log_softmax(seg.float(), dim=-1)
