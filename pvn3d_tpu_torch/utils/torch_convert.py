"""Seed the image trunk from a torchvision ResNet-34 state dict.

The trunk half of the JAX package's ``utils/torch_convert.py``
(``convert_resnet34`` ``:43``, ``load_resnet34_into`` ``:74``).  The
reference initialises its image trunk from torchvision's pretrained
resnet34 (pvn3d/lib/extractors.py:204-224, a model-zoo download) before
training.  The port's trunk (``models/resnet.py::DilatedResNet``) keeps
torchvision's module names under ``cnn.model.feats.`` (``conv1``,
``bn1``, ``layer{s}.{b}.{conv1,bn1,conv2,bn2}``,
``layer{s}.0.downsample.{0,1}``), so the map is a key prefix and no
layout change; the classifier ``fc.*`` and BN's ``num_batches_tracked``
are dropped.  No file is downloaded: the caller passes a local file.

A full reference PVN3D checkpoint needs no converter here: it loads with
``utils/weights.py::load_torch_state_dict`` and
``load_state_dict(strict=True)``, its keys being the port's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from pvn3d_tpu_torch.utils.weights import load_torch_state_dict

# Where the image trunk sits in the port's PVN3D state dict
# (models/pvn3d.py: ``cnn.model`` is the PSPNet, ``feats`` its trunk).
TRUNK_PREFIX = "cnn.model.feats."


def _dropped(key: str) -> bool:
    return key.startswith("fc.") or key.endswith("num_batches_tracked")


def convert_resnet34(sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision resnet state dict -> the port's trunk keys (float32
    CPU tensors under ``TRUNK_PREFIX``), without ``fc.*`` and
    ``num_batches_tracked``."""
    return {TRUNK_PREFIX + k: torch.as_tensor(v).detach().float().cpu()
            for k, v in sd.items() if not _dropped(k)}


def load_resnet34_into(model: nn.Module, src: Union[str, Mapping]) -> int:
    """Copy a torchvision ResNet-34 state dict (a mapping or a ``.pth``
    path) into ``model``'s trunk in place, before any optimizer step, and
    return the number of tensors copied.

    Raises ``KeyError`` for a trunk tensor with no target in ``model`` or
    a trunk target the dict leaves unfilled, and ``ValueError`` for a
    shape mismatch; nothing is copied then.
    """
    sd = load_torch_state_dict(src) if isinstance(src, str) else src
    converted = convert_resnet34(sd)
    target = {k: v for k, v in model.state_dict().items()
              if k.startswith(TRUNK_PREFIX) and not _dropped(k)}
    extra = sorted(set(converted) - set(target))
    missing = sorted(set(target) - set(converted))
    if extra:
        raise KeyError(f"no target for trunk tensors {extra[:8]}")
    if missing:
        raise KeyError(f"trunk tensors left unfilled: {missing[:8]}")
    for k, v in converted.items():
        if tuple(target[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(target[k].shape)} vs {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in converted.items():
            target[k].copy_(v)
    return len(converted)
