"""Plain reference of FFB6D's training step (He et al., CVPR 2021;
ethnhe/FFB6D ``ffb6d/train_ycb.py``): the literal published graph of
``perfbench/reference/ffb6d.py`` in train mode, in float32, and the loss
of ``train_ycb.py`` (focal seg loss and the keypoint and centre offset L1
terms, weighted 2 / 1 / 1, as ``perfbench/drivers/train.py::
reference_steps`` computes PVN3D's).  Gradients come from autograd.

Train mode: every BN normalises by its batch statistics (biased
variance); the image branch's dropouts apply the masks given, in the
order the program draws them (after PSP, after ``up_1``, after
``up_2``); ``up_3`` and ``final`` run at every pixel.  ``checkpoint``
recomputes each image stage, RandLA block, fusion stage and head in the
backward, so a float32 batch of 24 fits on one card.

Departures from the source, as the configuration's ``assumed`` lists
them: the dropouts are elementwise masks at the places of the source's
``Dropout2d``; BN statistics are over the whole batch given (the
source's synchronised BN over 8 ranks of 3 frames).  Imports nothing of
the port.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.ffb6d import FFB6DReference
from perfbench.reference.model import Reference


class FFB6DTrainReference(FFB6DReference):
    """``forward(pointcloud, rgb, choose, idx, masks)`` in train mode ->
    seg_logits, kp_offsets, ctr_offsets and each head's last hidden
    layer (seg_hidden, kp_hidden, ctr_hidden), float32; ``batch_stats``
    False keeps every BN on its running statistics (the rest stays in
    train mode)."""

    def __init__(self, model_cfg: Dict, sd: Dict[str, torch.Tensor],
                 low_precision: bool = False, checkpoint: bool = True,
                 batch_stats: bool = True):
        Reference.__init__(self, model_cfg, sd, train=batch_stats,
                           low_precision=low_precision,
                           checkpoint=checkpoint)
        self._masks: List[torch.Tensor] = []
        self._hidden: Dict[str, torch.Tensor] = {}

    def forward(self, pointcloud, rgb, choose, idx,
                masks: List[torch.Tensor]):
        self._masks = list(masks)
        out = super().forward(pointcloud, rgb, choose, idx)
        if self._masks:
            raise ValueError(f"{len(self._masks)} dropout masks left over")
        out.update(kp_hidden=self._hidden.pop("kp_ofst_layer"),
                   ctr_hidden=self._hidden.pop("ctr_ofst_layer"))
        return out

    def _drop(self, x, rate):
        return x * self._masks.pop(0) / (1.0 - rate)

    def _image_ds(self, i, x):
        y = self._stage(super()._image_ds, i, x)
        return self._drop(y, self.cfg["cnn"]["dropout_psp"]) if i == 3 else y

    def _image_up(self, i, x):
        y = super()._image_up(i, x)
        return self._drop(y, self.cfg["cnn"]["dropout_up"]) if i < 2 else y

    def _upsample(self, x, k):
        return self._stage(super()._upsample, x, k)

    def _final(self, x):
        return self._stage(super()._final, x)

    def _res_block(self, i, feats, xyz, nei):
        return self._stage(super()._res_block, i, feats, xyz, nei)

    def _fuse(self, kind, i, rgb0, p0, p2r, r2p):
        return self._stage(super()._fuse, kind, i, rgb0, p0, p2r, r2p)

    def _head(self, fused, name, n_hidden, output=True):
        hidden = self._stage(super()._head, fused, name, n_hidden, False)
        if not output:
            return hidden
        self._hidden[name] = hidden.detach()
        return self.dense(hidden, f"{name}.{n_hidden}.conv")


def loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         train_cfg: Dict) -> torch.Tensor:
    """The weighted total: the focal loss of the seg logits (a mean over
    points) and the L1 keypoint and centre offset terms over each frame's
    foreground points (summed over frames)."""
    w = train_cfg["loss_weights"]
    labels = batch["labels"].long()
    logp = F.log_softmax(out["seg_logits"], -1)
    logpt = logp.gather(-1, labels[..., None])[..., 0]
    seg = (-((1.0 - logpt.detach().exp()) ** train_cfg["focal_gamma"])
           * logpt).mean()
    fg = (labels > 0).float()
    offs = []
    for key, tgt in (("kp_offsets", "kp_targ_ofst"),
                     ("ctr_offsets", "ctr_targ_ofst")):
        diff = (out[key] - batch[tgt].permute(0, 2, 1, 3)).abs() \
            * fg[:, None, :, None]
        offs.append((diff.sum((2, 3)) / (fg.sum(1)[:, None] + 1e-3)).sum())
    return w[0] * seg + w[1] * offs[0] + w[2] * offs[1]
