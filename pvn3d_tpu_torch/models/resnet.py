"""Stride-8 ResNet-34 trunk of the image branch (NCHW, eval and train mode).

Port of the JAX package's ``models/resnet.py::DilatedResNet`` as the
reference graph: layers 1/2 stride 1/2, layers 3/4 stride 1 (output
stride 8).  The reference passes dilation 2/4 to layers 3/4 but the
argument is dead code (extractors.py:134-135, see PARITY.md), so the
trained network has no dilation; ``dilations`` defaults to that and keeps
the properly dilated variant as a knob.  The JAX package's TPU regroupings
(``fold2``, ``_phase_kernel3``, ``_phase_entry_kernel3``, ``_stem_s2d``)
compute the same multiply-adds and are not ported.  Module names follow
torchvision (``layer{s}.{b}.conv1``, ``downsample.0``), the reference
checkpoint's ``cnn.model.feats.*`` keys.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.models.layers import (BatchNorm, conv2d,
                                           max_pool_3x3_s2, named_sequential)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (named_sequential(
            **{"0": nn.Conv2d(c_in, planes, 1, stride=stride, bias=False),
               "1": BatchNorm(planes)}) if downsample else None)

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        y = self.bn1.nchw(conv2d(x, self.conv1), bn_momentum, relu=True)
        y = self.bn2.nchw(conv2d(y, self.conv2), bn_momentum)
        res = x
        if self.downsample is not None:
            res = self.downsample[1].nchw(conv2d(x, self.downsample[0]),
                                          bn_momentum)
        return F.relu(y + res)


class DilatedResNet(nn.Module):
    """ResNet-(18/34) with output stride 8; returns the 512-channel
    stride-8 map (NCHW)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dilations: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_planes = 64
        # (planes, stride) per stage; stride-8 tail (strides 1 in 3/4).
        for s, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 1),
                                              (512, 1))):
            blocks = []
            for b in range(layers[s]):
                first = b == 0
                blocks.append(BasicBlock(
                    in_planes if first else planes, planes,
                    stride=stride if first else 1, dilation=dilations[s],
                    downsample=first and (stride != 1
                                          or in_planes != planes)))
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
            in_planes = planes

    def stem(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """conv1 + BN + ReLU + the 3x3 max pool: stride 4, 64 channels."""
        x = self.bn1.nchw(conv2d(x, self.conv1), bn_momentum, relu=True)
        return max_pool_3x3_s2(x)

    def stage(self, s: int, x: torch.Tensor, bn_momentum=0.1
              ) -> torch.Tensor:
        """``layer{s}`` (s = 1..4); FFB6D runs the stages one by one."""
        for block in getattr(self, f"layer{s}"):
            x = block(x, bn_momentum)
        return x

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        x = self.stem(x, bn_momentum)
        for s in range(1, 5):
            x = self.stage(s, x, bn_momentum)
        return x
