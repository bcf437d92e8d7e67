"""Pose accuracy: ADD, ADD-S, VOC AP AUC and threshold accuracy.

Port of the JAX package's ``geometry/metrics.py`` (the reference's
basic_utils.py:32-44 VOCap, :597-604 cal_auc, :617-635 cal_add_cuda /
cal_adds_cuda).  ADD and ADD-S take masks for padded meshes and any
leading batch axes, so a batch of instances is one call.  The AUC
helpers are host numpy over accumulated distance lists.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pvn3d_tpu_torch.geometry.se3 import transform_points


def _masked_mean(dis: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return dis.mean(dim=-1)
    m = mask.float()
    return (dis * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1e-9)


def cal_add(pred_pose: torch.Tensor, gt_pose: torch.Tensor,
            pts: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """ADD: mean distance between the mesh points under the predicted and
    the GT pose (basic_utils.py:617-623).  ``mask`` (..., N) marks the
    mesh's real points."""
    pred = transform_points(pred_pose, pts)
    gt = transform_points(gt_pose, pts)
    return _masked_mean(torch.linalg.vector_norm(pred - gt, dim=-1), mask)


def cal_adds(pred_pose: torch.Tensor, gt_pose: torch.Tensor,
             pts: torch.Tensor, mask: Optional[torch.Tensor] = None,
             chunk: int = 512) -> torch.Tensor:
    """ADD-S: for each GT-posed mesh point, the distance to the nearest
    predicted-posed point, averaged (basic_utils.py:625-635).

    d^2 is the expanded |a|^2 - 2ab + |b|^2 of the JAX package, with the
    product a float32 ``matmul`` (TF32 off, ``utils.device.disable_tf32``)
    and padded predicted points at |b|^2 = 1e12 so they are never the
    nearest; GT rows go ``chunk`` at a time, so a mesh of a few thousand
    points never builds its whole N x N matrix.
    """
    pred = transform_points(pred_pose, pts)
    gt = transform_points(gt_pose, pts)
    n = pts.shape[-2]
    if mask is None:
        mask = torch.ones(pred.shape[:-1], dtype=torch.bool,
                          device=pred.device)
    m = mask.float()
    pred_sq = (pred * pred).sum(dim=-1)
    pred_sq_inf = torch.where(m > 0, pred_sq, 1e12)
    pred_t = pred.transpose(-1, -2)
    mins = []
    for s in range(0, n, chunk):
        gt_c = gt[..., s:s + chunk, :]
        gt_sq = (gt_c * gt_c).sum(dim=-1)
        cross = torch.matmul(gt_c, pred_t)
        d2 = gt_sq[..., :, None] - 2.0 * cross + pred_sq_inf[..., None, :]
        mins.append(d2.amin(dim=-1))
    mdis = torch.sqrt(torch.clamp(torch.cat(mins, dim=-1), min=0.0))
    return (mdis * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1e-9)


def voc_ap(rec, prec) -> float:
    """VOC average precision over the [0, 0.1] recall-distance range
    (basic_utils.py:32-44)."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    idx = np.where(rec != np.inf)[0]
    if len(idx) == 0:
        return 0.0
    rec = rec[idx]
    prec = prec[idx]
    mrec = np.concatenate([[0.0], rec, [0.1]])
    mpre = np.concatenate([[0.0], prec, [prec[-1]]])
    for i in range(1, mpre.shape[0]):
        mpre[i] = max(mpre[i], mpre[i - 1])
    i = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) * 10)


def cal_auc(add_dis, max_dis: float = 0.1) -> float:
    """AUC (x100) of the accuracy-vs-distance curve up to ``max_dis``
    (basic_utils.py:597-604): distances above it become +inf, accuracy is
    the CDF, and VOC AP integrates it."""
    d = np.asarray(add_dis, np.float64).copy()
    if d.size == 0:
        return 0.0
    d[d > max_dis] = np.inf
    d = np.sort(d)
    n = len(d)
    acc = np.cumsum(np.ones(n)) / n
    return voc_ap(d, acc) * 100.0


def add_accuracy_at(add_dis, threshold: float) -> float:
    """Percentage of frames with distance < ``threshold`` (LineMOD's
    ADD-0.1d, pvn3d_eval_utils.py:314-317)."""
    d = np.asarray(add_dis, np.float64)
    if d.size == 0:
        return 0.0
    return float(np.mean(d < threshold) * 100.0)
