"""Batched point-to-point ICP refinement.

Port of the JAX package's ``inference/icp.py`` (reference: eval_icp.py and
lib/utils/icp/icp.py, per-object sequential ICP with an sklearn 1-NN per
iteration).  Every (frame, object) refinement problem is one row of a
padded (B, ...) problem: brute-force nearest neighbours by a float32
matmul, a batched weighted Umeyama fit per iteration, and per-problem
convergence flags.

Reference semantics kept (icp.py:141-192):
  * correspondence direction is scene -> source: every SCENE point matches
    its nearest transformed-mesh point;
  * the incremental fit maps the matched source points onto the scene;
  * stop when |prev_err - err| < tolerance (per problem) or max_iter;
  * the pose accumulates from ``init_pose``.

The JAX loop is a ``lax.while_loop`` on the device.  Here the host runs the
iterations and reads the "any problem active" flag before each one, as
JAX's loop condition does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from pvn3d_tpu_torch.geometry.cloud import depth_to_cloud_map
from pvn3d_tpu_torch.geometry.se3 import best_fit_transform, transform_points
from pvn3d_tpu_torch.ops.kernels.winner import winner_stats

# Bounds of the fixed full-resolution subsample priorities (the JAX
# package draws ``uniform(PRNGKey(0), (P,), 1e-3, 1.0)``).
_PRIORITY_MIN = 1e-3


def compose_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) composition: result = a o b (apply b first)."""
    r = torch.matmul(a[..., :3, :3], b[..., :3, :3])
    t = torch.matmul(a[..., :3, :3], b[..., :3, 3:]) + a[..., :3, 3:]
    return torch.cat([r, t], dim=-1)


def icp_refine(mesh_pts: torch.Tensor, mesh_valid: torch.Tensor,
               scene_pts: torch.Tensor, scene_valid: torch.Tensor,
               init_pose: torch.Tensor, max_iter: int = 500,
               tolerance: float = 1e-9):
    """Refine a batch of initial poses against scene point clusters.

    Args:
      mesh_pts: (B, M, 3) canonical mesh points (padded).
      mesh_valid: (B, M) bool.
      scene_pts: (B, K, 3) camera-frame scene points (padded).
      scene_valid: (B, K) bool.
      init_pose: (B, 3, 4) initial poses (e.g. PVN3D predictions).
      max_iter / tolerance: reference values 500 / 1e-9 (eval_icp.py:181).

    Returns:
      (poses (B, 3, 4), mean_err (B,), n_iter (B,) int32, the shared
      iteration count broadcast to every problem).
    """
    mesh_pts = mesh_pts.float()
    scene_pts = scene_pts.float()
    mesh_valid = mesh_valid.bool()
    dev = mesh_pts.device
    b = mesh_pts.shape[0]
    sc_w = scene_valid.float()
    sc_n = torch.clamp(sc_w.sum(dim=-1), min=1e-9)
    sc_sq = torch.sum(scene_pts * scene_pts, dim=-1)

    def nn_match(pose):
        src = transform_points(pose, mesh_pts)             # (B, M, 3)
        src_sq = torch.where(mesh_valid, torch.sum(src * src, dim=-1),
                             1e12)
        # JAX's expanded d^2, (|s|^2 - 2 s.m) + |m|^2, built in place.
        d2 = torch.bmm(scene_pts, src.transpose(1, 2))
        d2.mul_(-2.0).add_(sc_sq[..., None]).add_(src_sq[:, None, :])
        mind, idx = torch.min(d2, dim=-1)                  # first argmin
        matched = torch.gather(src, 1, idx[..., None].expand(-1, -1, 3))
        return matched, torch.sqrt(torch.clamp(mind, min=0.0))

    pose = init_pose.float()
    prev_err = torch.zeros(b, device=dev)
    err = torch.zeros(b, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    n_iter = 0
    while n_iter < max_iter and bool(active.any()):
        matched, dist = nn_match(pose)
        err = torch.sum(dist * sc_w, dim=-1) / sc_n
        inc = best_fit_transform(matched, scene_pts, weights=sc_w)
        pose = torch.where(active[:, None, None],
                           compose_poses(inc, pose), pose)
        # The reference's 1e-9 absolute test was written for float64; in
        # float32 one ulp of err exceeds it once err > ~1.7 cm, so changes
        # at err's rounding level count as converged.
        tol = torch.clamp(err * 1.2e-7, min=tolerance)
        active = active & (torch.abs(prev_err - err) >= tol)
        prev_err = err
        n_iter += 1
    return pose, err, torch.full((b,), n_iter, dtype=torch.int32,
                                 device=dev)


def biggest_cluster_mask(points: torch.Tensor, valid: torch.Tensor,
                         bandwidth: float = 0.06) -> torch.Tensor:
    """Membership mask of the dominant MeanShift cluster per point set
    (reference: get_cld_bigest_clus, eval_icp.py:56-64, sklearn MeanShift
    bandwidth 0.06, keep cluster 0 == biggest).

    The JAX function runs ``mean_shift_fit`` and keeps only its labels:
    the winning seed's original-position membership row, which kernel K4
    (``winner_stats``) computes alone, so no shift step runs here.
    """
    _, labels, _ = winner_stats(points.float(), valid.bool(), bandwidth)
    return labels & valid.bool()


def propagate_labels_fullres(cloud_flat: torch.Tensor, valid: torch.Tensor,
                             sample_cld: torch.Tensor,
                             sample_labels: torch.Tensor,
                             chunk: int = 4096) -> torch.Tensor:
    """1-NN label propagation from the sampled cloud to the full-res cloud
    (reference: fill_label_item, eval_icp.py:388-426).

    Args:
      cloud_flat: (P, 3) full-res camera-frame points.
      valid: (P,) bool (depth > 1e-6).
      sample_cld: (N, 3) sampled points.
      sample_labels: (N,) int32 predicted labels of the samples.

    Returns: (P,) int32 labels (0 where invalid).  Each ``chunk`` rows are
    one (chunk, N) float32 matmul block with JAX's d^2, |s|^2 - 2 p.s
    (|p|^2 is omitted: it does not move the argmin), first argmin.
    """
    pts = cloud_flat.float()
    samples = sample_cld.float()
    s_sq = torch.sum(samples * samples, dim=-1)
    idx = torch.empty(pts.shape[0], dtype=torch.long, device=pts.device)
    for start in range(0, pts.shape[0], chunk):
        d2 = torch.addmm(s_sq, pts[start:start + chunk], samples.T,
                         alpha=-2.0)
        idx[start:start + chunk] = torch.argmin(d2, dim=-1)
    labels = sample_labels.to(torch.int32)[idx]
    return torch.where(valid, labels, 0)


@functools.lru_cache(maxsize=4)
def _fixed_priorities(p: int, device: torch.device) -> torch.Tensor:
    """One uniform draw in [1e-3, 1) per pixel from a generator seeded 0
    on ``device``: the same subset on every call (the JAX package's
    threefry draw cannot be reproduced; tests pass it in)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    u = torch.rand(p, generator=gen, device=device)
    return torch.clamp(u * (1.0 - _PRIORITY_MIN) + _PRIORITY_MIN,
                       min=_PRIORITY_MIN)


def fullres_class_clouds(depth: torch.Tensor, cam_k: torch.Tensor,
                         sample_cld: torch.Tensor,
                         sample_labels: torch.Tensor, n_cls: int,
                         k_per_class: int,
                         label_map: Optional[torch.Tensor] = None,
                         priorities: Optional[torch.Tensor] = None):
    """Per-class scene clouds from one full-resolution depth map (H, W) in
    metres and its (3, 3) intrinsics.

    Reference scene construction (eval_icp.py:124-170): the class mask on
    the FULL-RES depth (the predicted mask 1-NN-upsampled, or the GT
    label map when ``label_map`` is given), a random subset of
    ``k_per_class`` of its pixels, with the ICP gate on the full-res class
    count (:146-151).  The subset is the ``k_per_class`` class pixels of
    highest priority, equal priorities lower index first (``lax.top_k``'s
    order, by a stable descending sort); slots past the count hold the
    lowest-index pixels outside the class, masked, as JAX's do.
    ``priorities`` (P,) in (0, 1] replace the fixed draw.

    Returns (scene (n_cls-1, k, 3), valid (n_cls-1, k), counts (n_cls-1,)
    int32).  Class c sits at row c-1 (background excluded).
    """
    cloud_map, valid_map = depth_to_cloud_map(depth, cam_k, 1.0)
    p = depth.shape[-2] * depth.shape[-1]
    cloud = cloud_map.reshape(p, 3)
    valid = valid_map.reshape(p)
    if label_map is None:
        labels = propagate_labels_fullres(cloud, valid, sample_cld,
                                          sample_labels)
    else:
        labels = torch.where(valid, label_map.reshape(p).to(torch.int32), 0)
    if priorities is None:
        priorities = _fixed_priorities(p, cloud.device)
    cls_ids = torch.arange(1, n_cls, dtype=torch.int32, device=cloud.device)
    mask = valid[None, :] & (labels[None, :] == cls_ids[:, None])
    counts = mask.sum(dim=-1, dtype=torch.int32)
    score = torch.where(mask, priorities.float()[None, :], -1.0)
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k_per_class], idx[:, :k_per_class]
    return cloud[idx], top > 0.0, counts


def refine_frame_poses(init_poses, mesh_pts, mesh_valid, scene_pts,
                       scene_valid, min_points: int = 1500,
                       cluster_bandwidth: float = 0.06,
                       max_iter: int = 500, tolerance: float = 1e-9,
                       use_cluster_filter: bool = True,
                       gate_counts: Optional[torch.Tensor] = None):
    """Per-class refinement with the reference's gating: classes with fewer
    than ``min_points`` scene points keep their initial pose
    (eval_icp.py:146-151); the scene cloud is prefiltered to its biggest
    cluster (:56-64).

    All arguments batched over problems: (C, ...) tensors.
    ``gate_counts`` overrides the point count the gate sees: the reference
    gates on the full-res class pixel count *before* capping and cluster
    filtering (eval_icp.py:130-151), which the full-res path passes here.
    Returns (poses, err, n_iter) as ``icp_refine``.
    """
    scene_valid = scene_valid.bool()
    n_pts = (scene_valid.sum(dim=-1) if gate_counts is None
             else gate_counts)
    if use_cluster_filter:
        scene_valid = biggest_cluster_mask(scene_pts, scene_valid,
                                           bandwidth=cluster_bandwidth)
    refined, err, iters = icp_refine(
        mesh_pts, mesh_valid, scene_pts, scene_valid, init_poses,
        max_iter=max_iter, tolerance=tolerance)
    keep = n_pts >= min_points
    poses = torch.where(keep[:, None, None], refined, init_poses.float())
    return poses, err, iters
