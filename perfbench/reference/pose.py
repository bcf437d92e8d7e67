"""Plain reference of the pose stage: votes -> MeanShift clusters -> the
least-squares fit of each class's keypoints.

A frozen copy of the port's plain pose stage (``inference/pose.py``,
``inference/meanshift.py`` in winner mode, ``geometry/se3.py``), which
follows pvn3d_eval_utils.py:37-110 (bandwidth 0.08, the centre-cluster
filter, the per-class radius mask refinement) in float32, with the
winner statistics of ``perfbench/reference/ops.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from perfbench.reference.ops import winner_stats

_UNROLL = 4


def mean_shift_fit(points, mask, bandwidth, max_iter=300):
    points = points.float()
    mask = mask.bool()
    win, labels, counts = winner_stats(points, mask, bandwidth)
    bw = torch.tensor(bandwidth, dtype=torch.float32, device=points.device)
    bw2 = bw * bw
    stop = float(bw * 1e-3)
    wmask = mask.float()
    rows = torch.arange(points.shape[0], device=points.device)
    c = points[rows, win.long()]

    def shift_once(c):
        d2 = ((points - c[:, None, :]) ** 2).sum(dim=-1)
        w = torch.exp(-0.5 * d2 / bw2) * wmask
        wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-20)
        return torch.einsum("hk,hkc->hc", w, points) / wsum

    it = 0
    while True:
        for _ in range(_UNROLL):
            new_c = shift_once(c)
            shift = torch.linalg.vector_norm(new_c - c, dim=-1)
            c = new_c
        it += _UNROLL
        if it >= max_iter or float(shift.max()) < stop:
            break
    return c, labels, counts


def best_fit_transform(src: torch.Tensor, dst: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Least-squares rigid transform mapping ``src`` onto ``dst``:
    (..., N, 3) x 2 -> (..., 3, 4) with ``dst ~= src @ R^T + t``.

    ``weights`` (..., N), nonnegative, weigh the points (uniform when not
    given); they are normalised by ``max(sum, 1e-12)``, so zero-weight
    rows are ignored.  With all weights zero the cross-covariance is 0 and
    the rotation is whatever the SVD returns for it.
    """
    src = src.float()
    dst = dst.float()
    if weights is None:
        wn = torch.full(src.shape[:-1], 1.0 / src.shape[-2],
                        device=src.device)
    else:
        w = weights.float()
        wn = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    c_src = torch.einsum("...n,...nc->...c", wn, src)
    c_dst = torch.einsum("...n,...nc->...c", wn, dst)
    src_c = src - c_src[..., None, :]
    dst_c = dst - c_dst[..., None, :]
    h = torch.einsum("...nc,...n,...nd->...cd", src_c, wn, dst_c)
    u, _, vt = torch.linalg.svd(h)
    # Reflection fix: flip the last singular vector when det(V U^T) < 0.
    det = torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2))
    sign = torch.sign(det)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    d = torch.ones(vt.shape[:-2] + (3,), device=src.device)
    d[..., -1] = sign
    r = torch.einsum("...ji,...j,...jk->...ik", vt, d, u.transpose(-1, -2))
    t = c_dst - torch.einsum("...ij,...j->...i", r, c_src)
    return torch.cat([r, t[..., :, None]], dim=-1)


def identity_pose(batch_shape=(), device=None) -> torch.Tensor:
    """Identity [I | 0] pose (the reference's fallback for empty classes,
    pvn3d_eval_utils.py:80)."""
    eye = torch.cat([torch.eye(3, device=device),
                     torch.zeros(3, 1, device=device)], dim=1)
    return eye.expand(tuple(batch_shape) + (3, 4))


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
    valid = ar[None, :] < torch.minimum(count, torch.tensor(k, device=dev)
                                        )[:, None]
    return sel, valid, count


def cal_frame_poses(pcld: torch.Tensor, mask: torch.Tensor,
                    ctr_of: torch.Tensor, kp_of: torch.Tensor,
                    mesh_kps: torch.Tensor, radii: torch.Tensor,
                    n_cls: int, n_kps: int = 8, k: int = 512,
                    bandwidth: float = 0.08, max_iter: int = 300,
                    use_ctr: bool = True, use_ctr_clus_filter: bool = True,
                    refine_mask: bool = True):
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

    ctr_centers, ctr_labels, _ = mean_shift_fit(pred_ctr[sel], valid,
                                                bandwidth, max_iter=max_iter)
    # if ctr_labels.sum() < 1: ctr_labels[0] = 1  (reference :85-86)
    no_lab = ctr_labels.sum(dim=1) < 1
    ctr_labels = ctr_labels.clone()
    ctr_labels[:, 0] |= no_lab

    kp_valid = valid & ctr_labels if use_ctr_clus_filter else valid
    kp_votes = pred_kp[:, sel, :].permute(1, 0, 2, 3)   # (nf, n_kps, k, 3)
    kp_centers, _, _ = mean_shift_fit(
        kp_votes.reshape(nf * n_kps, k, 3),
        kp_valid[:, None, :].expand(nf, n_kps, k).reshape(nf * n_kps, k),
        bandwidth, max_iter=max_iter)
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
    return poses, present_full
