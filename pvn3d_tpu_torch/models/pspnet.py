"""PSPNet image branch: trunk -> pyramid pooling -> 3x upsample -> heads.

Port of the JAX package's ``models/pspnet.py`` on the dense path
(``PSPModule``, ``PSPUpsample.__call__``, ``PSPNetEmbedding`` without
``choose``): the reference Modified_PSPNet (pspnet.py:7-90).  The eval
restructures ``PSPUpsample.fused`` / ``.sparse`` equal this graph up to
summation order and are not ported.  Train mode (``module.train()``)
takes this same dense path, with batch-statistics BN and the two
elementwise dropouts of the JAX package (``dropout_psp`` after the pyramid,
``dropout_up`` after the first two upsamples).  Runs NCHW inside; its
interface is channels-last like the JAX package's.  Module names give the
reference checkpoint's ``cnn.model.*`` keys (``psp.stages.{i}.1``,
``up_{k}.conv.{1,2,3}``, ``final.0``, ``final_seg.0``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.models.layers import (BatchNorm, PReLU,
                                           adaptive_avg_pool, conv2d,
                                           dropout, named_sequential,
                                           resize_bilinear)
from pvn3d_tpu_torch.models.resnet import DilatedResNet


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


class PSPNetEmbedding(nn.Module):
    """Full image branch.  ``forward(rgb (B, H, W, 3))`` returns the
    per-pixel embedding ``(B, H, W, embedding_dim)`` and the auxiliary
    log-softmax seg map ``(B, H, W, n_classes)``, channels-last."""

    def __init__(self, n_classes: int = 22, sizes: Sequence[int] = (1, 2, 3, 6),
                 psp_features: int = 512, psp_out: int = 1024,
                 up_channels: Sequence[int] = (256, 64, 64),
                 embedding_dim: int = 128,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 dropout_psp: float = 0.3, dropout_up: float = 0.15):
        super().__init__()
        self.dropout_psp = dropout_psp
        self.dropout_up = dropout_up
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
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.feats(rgb.permute(0, 3, 1, 2), bn_momentum)
        x = dropout(self.psp(x), self.dropout_psp, self.training, generator)
        for k in range(1, self.n_up + 1):
            x = getattr(self, f"up_{k}")(x, bn_momentum)
            if k < self.n_up:
                x = dropout(x, self.dropout_up, self.training, generator)
        emb = conv2d(x, self.final[0]).permute(0, 2, 3, 1)
        seg = conv2d(x, self.final_seg[0]).permute(0, 2, 3, 1)
        return emb, F.log_softmax(seg.float(), dim=-1)
