"""Frame poses from per-point votes: select -> cluster -> refine -> fit.

Port of the JAX package's ``inference/pose.py`` (reference:
pvn3d_eval_utils.py:37-110 ``cal_frame_poses``).  Per frame:

  1. per-class point selection, up to K evenly strided class points;
  2. all (class, center) problems -> one batched MeanShift;
  3. center-distance mask refinement (YCB, :59-72);
  4. (class, center) and (class, keypoint) problems -> two more MeanShifts;
  5. batched Umeyama fit against the canonical mesh keypoints.

A class absent from the predicted mask gets a ZERO pose; a class predicted
but emptied by refinement gets the IDENTITY pose (pose.py:153-158 of the
JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pvn3d_tpu_torch.geometry.se3 import best_fit_transform, identity_pose
from pvn3d_tpu_torch.inference.meanshift import mean_shift_fit
from pvn3d_tpu_torch.utils.profiling import annotate


class FramePoses(NamedTuple):
    poses: torch.Tensor      # (n_cls, 3, 4) — row 0 unused (background)
    present: torch.Tensor    # (n_cls,) bool — class in the predicted mask
    kps: torch.Tensor        # (n_cls, n_kps+1, 3) clustered keypoints+center


def _select_class_points(mask: torch.Tensor, n_cls: int, k: int):
    """Evenly strided selection of up to k points per foreground class:
    sel (n_cls-1, k) indices into N, valid (n_cls-1, k) bool, count
    (n_cls-1,) int32.  Sorting point indices by class (stable, background
    last) makes each class a contiguous run."""
    n = mask.shape[0]
    dev = mask.device
    classes = torch.arange(1, n_cls, device=dev, dtype=mask.dtype)
    count = (mask[:, None] == classes[None, :]).sum(dim=0,
                                                    dtype=torch.int32)
    key = torch.where(mask > 0, mask, n_cls)
    order = torch.argsort(key, stable=True)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(count, 0, dtype=torch.int32)[:-1]])
    ar = torch.arange(k, dtype=torch.int32, device=dev)
    strided = torch.div(ar[None, :] * count[:, None], k,
                        rounding_mode="floor")
    pos = torch.where(count[:, None] > k, strided, ar[None, :])
    sel = order[torch.clamp(offsets[:, None] + pos, 0, n - 1).long()]
    valid = ar[None, :] < torch.clamp(count, max=k)[:, None]
    return sel, valid, count


def cal_frame_poses(pcld: torch.Tensor, mask: torch.Tensor,
                    ctr_of: torch.Tensor, kp_of: torch.Tensor,
                    mesh_kps: torch.Tensor, radii: torch.Tensor,
                    n_cls: int, n_kps: int = 8, k: int = 512,
                    bandwidth: float = 0.08, max_iter: int = 300,
                    use_ctr: bool = True, use_ctr_clus_filter: bool = True,
                    refine_mask: bool = True) -> FramePoses:
    """Single-frame pose extraction.

    pcld (N, 3) camera-frame points; mask (N,) int32 predicted class;
    ctr_of (1, N, 3) and kp_of (n_kps, N, 3) predicted offsets; mesh_kps
    (n_cls, n_kps+1, 3) canonical keypoints + center; radii (n_cls,)
    per-class cluster radius for the mask refinement.
    """
    nf = n_cls - 1
    dev = pcld.device
    pred_ctr = pcld - ctr_of[0]
    pred_kp = pcld[None, :, :] - kp_of

    sel, valid, count = _select_class_points(mask, n_cls, k)
    present = count > 0

    if refine_mask and use_ctr_clus_filter:
        with annotate("pvn3d.meanshift.ctr_filter"):
            ctrs, _, _ = mean_shift_fit(pred_ctr[sel], valid, bandwidth,
                                        max_iter=max_iter)
        # Reassign foreground points to the nearest present class center
        # when within 0.8 * that class's radius (reference :59-72).
        d = torch.linalg.vector_norm(pred_ctr[:, None, :] - ctrs[None],
                                     dim=-1)
        d = torch.where(present[None, :], d, torch.inf)
        closest = torch.argmin(d, dim=1)      # first minimum
        min_dis = d.amin(dim=1)
        closest_cls = (closest + 1).to(mask.dtype)
        thresh = radii[closest_cls.long()] * 0.8
        update = (mask > 0) & (min_dis < thresh) & torch.isfinite(min_dis)
        mask = torch.where(update, closest_cls, mask)
        sel, valid, count = _select_class_points(mask, n_cls, k)

    with annotate("pvn3d.meanshift.ctr"):
        ctr_centers, ctr_labels, _ = mean_shift_fit(
            pred_ctr[sel], valid, bandwidth, max_iter=max_iter)
    # if ctr_labels.sum() < 1: ctr_labels[0] = 1  (reference :85-86)
    no_lab = ctr_labels.sum(dim=1) < 1
    ctr_labels = ctr_labels.clone()
    ctr_labels[:, 0] |= no_lab

    kp_valid = valid & ctr_labels if use_ctr_clus_filter else valid
    kp_votes = pred_kp[:, sel, :].permute(1, 0, 2, 3)   # (nf, n_kps, k, 3)
    kp_mask = kp_valid[:, None, :].expand(nf, n_kps, k).reshape(nf * n_kps, k)
    with annotate("pvn3d.meanshift.kp"):
        kp_centers, _, _ = mean_shift_fit(kp_votes.reshape(nf * n_kps, k, 3),
                                          kp_mask, bandwidth,
                                          max_iter=max_iter)
    kp_centers = kp_centers.reshape(nf, n_kps, 3)

    cls_kps = (torch.cat([kp_centers, ctr_centers[:, None, :]], dim=1)
               if use_ctr else kp_centers)
    fit = best_fit_transform(mesh_kps[1:, :cls_kps.shape[1], :], cls_kps)

    empty = count < 1
    poses_f = torch.where(empty[:, None, None], identity_pose((nf,), dev),
                          fit)
    poses_f = torch.where(present[:, None, None], poses_f, 0.0)
    poses = torch.cat([torch.zeros(1, 3, 4, device=dev), poses_f], dim=0)
    present_full = torch.cat(
        [torch.zeros(1, dtype=torch.bool, device=dev), present])
    kps_full = torch.cat(
        [torch.zeros((1,) + cls_kps.shape[1:], device=dev), cls_kps], dim=0)
    return FramePoses(poses=poses, present=present_full, kps=kps_full)
