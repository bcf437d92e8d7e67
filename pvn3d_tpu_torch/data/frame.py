"""Frame -> training-sample construction shared by the YCB and LineMOD
datasets.

Port of the JAX package's ``data/frame.py`` (the common tail of the
reference's get_item, ycb_dataset.py:206-306, linemod_dataset.py:
243-338): depth -> cloud unprojection, per-point color and normal
features, a fixed-size sample-or-wrap-pad to ``n_sample_points``, and the
GT keypoint and center offsets from the per-object poses.  A copy: the
same ``RandomState`` gives the same ``choose``, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from pvn3d_tpu_torch.data.normals import normals_from_depth_map


@dataclasses.dataclass
class FrameSpec:
    n_sample_points: int = 12288
    n_keypoints: int = 8
    n_min_points: int = 400          # reference: get_item returns None below
    max_instances: int = 12
    # Carry the full-resolution depth / intrinsics / label map in the
    # sample — needed by the full-res ICP scene path (reference:
    # eval_icp.py:224-291 refines against the full-res depth cloud).
    keep_depth: bool = False
    # Raw mode: the host skips depth completion, normals and point
    # sampling and ships raw rgb / depth / cam_k + GT poses; the frame is
    # built on the device (data/device_frame.py).
    device_preprocess: bool = False


def sample_point_budget(n_valid: int, n_sample: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Indices selecting exactly ``n_sample`` of ``n_valid`` points.

    Over-budget: uniform random subset without replacement, in index order
    (the reference shuffles a 0/1 mask then takes nonzeros,
    ycb_dataset.py:227-231 — same distribution).  Under-budget: wrap-pad
    (:233).

    When n_valid >> n_sample the subset is drawn by rejection (draw with
    replacement, dedupe, trim) instead of rng.choice's O(n_valid)
    Fisher-Yates — ~7 ms/frame at the YCB working point (300k valid,
    12288 sampled).  Conditioned on its size, the deduped set of iid
    uniform draws is uniform over subsets of that size, and trimming with
    a uniform sub-choice preserves that, so the distribution is identical.
    """
    if n_valid < n_sample:
        reps = -(-n_sample // n_valid)
        return np.tile(np.arange(n_valid), reps)[:n_sample]
    if n_valid < 4 * n_sample:
        # Rejection would collide too often; full permutation is cheap here.
        return np.sort(rng.choice(n_valid, n_sample, replace=False))
    # Expected collisions ~ m^2 / (2 n_valid); oversample well past that.
    extra = (int(n_sample * n_sample / n_valid)
             + 8 * int(np.sqrt(n_sample)) + 64)
    cand = np.unique(rng.randint(0, n_valid, n_sample + extra))
    while len(cand) < n_sample:              # vanishingly rare
        cand = np.unique(np.concatenate(
            [cand, rng.randint(0, n_valid, n_sample)]))
    if len(cand) > n_sample:
        cand = cand[np.sort(rng.choice(len(cand), n_sample, replace=False))]
    return cand


def build_targets(cld: np.ndarray, labels: np.ndarray,
                  instances: Sequence[tuple],
                  spec: FrameSpec):
    """GT arrays from per-object (cls_id, RT, mesh_kps, mesh_ctr) tuples.

    Offsets are point - transformed_target, written only at the labeled
    points of each object (reference: ycb_dataset.py:241-278).

    Returns dict with cls_ids (I,), rts (I,3,4), kp_3ds (I,n_kps,3),
    ctr_3ds (I,3), kp_targ_ofst (N,n_kps,3), ctr_targ_ofst (N,1,3).
    """
    n = len(cld)
    ni = spec.max_instances
    cls_ids = np.zeros((ni,), np.int32)
    rts = np.zeros((ni, 3, 4), np.float32)
    kp3ds = np.zeros((ni, spec.n_keypoints, 3), np.float32)
    ctr3ds = np.zeros((ni, 3), np.float32)
    kp_t = np.zeros((n, spec.n_keypoints, 3), np.float32)
    ctr_t = np.zeros((n, 1, 3), np.float32)
    for i, (cls_id, rt, kps, ctr) in enumerate(instances[:ni]):
        r, t = rt[:, :3], rt[:, 3]
        cls_ids[i] = cls_id
        rts[i] = rt
        ctr_cam = ctr @ r.T + t
        kps_cam = kps @ r.T + t
        ctr3ds[i] = ctr_cam
        kp3ds[i] = kps_cam
        idx = np.flatnonzero(labels == cls_id)
        ctr_t[idx, 0] = cld[idx] - ctr_cam[None, :]
        kp_t[idx] = cld[idx, None, :] - kps_cam[None, :, :]
    return {
        "cls_ids": cls_ids, "rts": rts, "kp_3ds": kp3ds, "ctr_3ds": ctr3ds,
        "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t,
    }


def build_frame(rgb: np.ndarray, depth: np.ndarray, label_map: np.ndarray,
                k: np.ndarray, cam_scale: float, instances: Sequence[tuple],
                spec: FrameSpec, rng: np.random.RandomState,
                normals: Optional[np.ndarray] = None):
    """Full frame -> sample dict (None when too few valid depth pixels).

    ``rgb`` is the (H, W, 3) float image in the dataset's native channel
    convention and 0-255 range (the reference feeds un-normalized 0-255
    values to both branches — ycb_dataset.py:215-220 keeps raw pixel
    values as point features and never applies its `self.norm`).
    """
    if spec.device_preprocess:
        if int(np.count_nonzero(depth > 1e-6)) < spec.n_min_points:
            return None
        targets = build_targets(np.zeros((0, 3), np.float32),
                                np.zeros((0,), np.int32), instances, spec)
        # Images/labels ship uint8 (raw test pixels are integers; every
        # consumer promotes) — 4x less collate/IPC traffic.
        sample = {
            "rgb": np.ascontiguousarray(rgb, np.uint8),
            "depth": depth.astype(np.float32),   # metric (already /scale)
            "cam_k": np.asarray(k, np.float32),
            "label_map": label_map.astype(np.int32),
            "cls_ids": targets["cls_ids"], "rts": targets["rts"],
            "kp_3ds": targets["kp_3ds"], "ctr_3ds": targets["ctr_3ds"],
        }
        return sample

    # Sample the point budget on the valid-pixel indices FIRST, then
    # unproject/gather only the sampled points (identical output to
    # subsampling after: all ops are per-point and sample_point_budget
    # returns ascending indices either way).
    if depth.ndim > 2:
        depth = depth[..., 0]
    flat_depth = np.ascontiguousarray(depth, np.float32).reshape(-1)
    choose_all = np.flatnonzero(flat_depth > 1e-6)
    if len(choose_all) < spec.n_min_points:
        return None
    sel = sample_point_budget(len(choose_all), spec.n_sample_points, rng)
    choose = choose_all[sel]

    w = depth.shape[1]
    z = flat_depth[choose] / cam_scale
    x = (choose % w - k[0, 2]) * z / k[0, 0]
    y = (choose // w - k[1, 2]) * z / k[1, 1]
    cld = np.stack([x, y, z], axis=1).astype(np.float32)

    if normals is None:
        normals = normals_from_depth_map(depth, k, cam_scale)
    nrm = normals.reshape(-1, 3)[choose]
    rgb_pt = rgb.reshape(-1, 3)[choose].astype(np.float32)
    labels = label_map.reshape(-1)[choose].astype(np.int32)
    choose = choose.astype(np.int32)

    targets = build_targets(cld, labels, instances, spec)
    pointcloud = np.concatenate([cld, rgb_pt, nrm], axis=1).astype(np.float32)
    sample = {
        "pointcloud": pointcloud,
        "rgb": rgb.astype(np.float32),
        "choose": choose,
        "labels": labels,
    }
    if spec.keep_depth:
        # depth arrives here already divided by cam_scale (metric), so the
        # full-res cloud is unproject(depth, k, 1.0) on the device.
        sample["depth"] = depth.astype(np.float32)
        sample["cam_k"] = np.asarray(k, np.float32)
        sample["label_map"] = label_map.astype(np.int32)
    sample.update(targets)
    return sample


def collate(samples) -> dict:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
