"""PointNet++ MSG trunk of the point branch (channels-last; eval and train
mode).

Port of the JAX package's ``models/pointnet2.py`` (the reference
Pointnet2MSG, pvn3d.py:46-154): four set-abstraction levels with
multi-scale ball-query grouping, shared MLP and max pool, then four
feature-propagation levels with exact 3-NN IDW interpolation.  Level 0 runs
FPS (kernel K1); levels 1-3 take the prefix of the previous level's
pick-ordered points when ``fps_prefix`` is set and FPS is not grouped
(greedy FPS is prefix consistent, ``config.py:133-142``); with
``fps_groups`` G > 1 every level runs grouped FPS, slab-sorted after
level 0.  Every level's ball query is kernel K2 in the config's
``query_mode`` (resolved by ``resolve_query_mode`` as the JAX package
does), every FP blend kernel K3 in its ``interp_mode``, whose backward
kernel carries the gradient to the known features in train mode (K1 and
K2 return indices and need none).  ``bn_momentum`` is passed down to every
BN.  The eval restructures ``sa/fp_precompute_first`` equal this graph up
to summation order and are not ported.  Module names give the reference
checkpoint's ``pointnet2.SA_modules.{i}.mlps.{j}`` / ``FP_modules.{i}.mlp``
keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pvn3d_tpu_torch.config import PointNet2Config, SALevelConfig
from pvn3d_tpu_torch.models.layers import SharedMLP
from pvn3d_tpu_torch.ops.grouping import ball_query_multi, group_points
from pvn3d_tpu_torch.ops.interpolate import (interp_expanded,
                                             three_interpolate_fused)
from pvn3d_tpu_torch.ops.sampling import (furthest_point_sample,
                                          gather_points)

# The backend ``resolve_query_mode`` is given: the port's kernels run on
# CUDA, where "auto" passes through to the exact ball query.
BACKEND = "cuda"


def resolve_query_mode(mode: str, train: bool, backend: str) -> str:
    """Phase-aware ball-query mode, the JAX package's rule
    (``pvn3d_tpu/models/pointnet2.py:28-42``): on a TPU "auto" trains
    through "approx" (training through the capacity-limited "pallas"
    kernel cost ~12 synthetic ADD-AUC there) and evaluates as "auto"
    (which its ball query resolves to "pallas"); elsewhere "auto" stays
    "auto", which the ball query runs as "exact".  Explicit modes pass
    through."""
    if mode != "auto":
        return mode
    if train:
        return "approx" if backend == "tpu" else "auto"
    return mode


class SetAbstractionMSG(nn.Module):
    """One SA level: centroids + per-radius group / MLP / max pool
    (pointnet2_modules.py:27-112)."""

    def __init__(self, level: SALevelConfig, c_in: int, use_xyz: bool = True,
                 fps_prefix: bool = False, fps_groups: int = 1,
                 fps_slab_sorted: bool = False, query_mode: str = "auto",
                 query_compute: str = "f32", query_capacity: int = 2):
        super().__init__()
        self.level = level
        self.use_xyz = use_xyz
        self.fps_prefix = fps_prefix
        self.fps_groups = fps_groups
        self.fps_slab_sorted = fps_slab_sorted
        self.query_mode = query_mode
        self.query_compute = query_compute
        self.query_capacity = query_capacity
        c0 = c_in + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList([SharedMLP(c0, w) for w in level.mlps])

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                dtype: torch.dtype, bn_momentum=0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fps_prefix:
            new_xyz = xyz[:, :self.level.npoint]
        else:
            idx = furthest_point_sample(xyz, self.level.npoint,
                                        groups=self.fps_groups,
                                        slab_sorted=self.fps_slab_sorted)
            new_xyz = gather_points(xyz, idx)
        mode = resolve_query_mode(self.query_mode, self.training, BACKEND)
        scale_idx = ball_query_multi(self.level.radii, self.level.nsamples,
                                     xyz, new_xyz, mode=mode,
                                     compute_dtype=self.query_compute,
                                     capacity=self.query_capacity)
        outs = []
        for g_idx, mlp in zip(scale_idx, self.mlps):
            grouped = group_points(xyz, g_idx) - new_xyz[:, :, None, :]
            if features is not None:
                feat = group_points(features, g_idx)
                grouped = (torch.cat([grouped, feat.to(grouped.dtype)], -1)
                           if self.use_xyz else feat)
            outs.append(mlp(grouped.to(dtype), bn_momentum).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """One FP level: 3-NN IDW interpolation + skip concat + shared MLP
    (pointnet2_modules.py:146-206).

    ``interp_mode`` as the JAX package resolves it (pointnet2.py:159-175):
    "pallas", and "auto" (which there becomes "pallas" on a TPU or under
    ``query_mode="pallas"``) run the fused kernel's direct d^2; "exact"
    and "approx" run the XLA ``three_nn`` arm's expanded d^2."""

    def __init__(self, c_in: int, widths, interp_mode: str = "auto"):
        super().__init__()
        self.mlp = SharedMLP(c_in, widths)
        self.expanded = interp_expanded(interp_mode)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats,
                dtype: torch.dtype, bn_momentum=0.1) -> torch.Tensor:
        interp, _, _ = three_interpolate_fused(unknown_xyz, known_xyz,
                                               known_feats.float(),
                                               expanded=self.expanded)
        interp = interp.to(dtype)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(dtype)], dim=-1)
        return self.mlp(interp, bn_momentum)


class PointNet2MSG(nn.Module):
    """(B, N, 3 + C_in) -> (B, N, fp_mlps[0][-1])."""

    def __init__(self, cfg: PointNet2Config):
        super().__init__()
        self.cfg = cfg
        sa, skips = [], [cfg.input_channels]
        c_in = cfg.input_channels
        grouped = cfg.fps_groups > 1
        for li, level in enumerate(cfg.sa_levels):
            sa.append(SetAbstractionMSG(
                level, c_in, cfg.use_xyz,
                fps_prefix=cfg.fps_prefix and not grouped and li > 0,
                fps_groups=cfg.fps_groups,
                fps_slab_sorted=grouped and li > 0,
                query_mode=cfg.query_mode, query_compute=cfg.query_compute,
                query_capacity=cfg.query_capacity))
            c_in = sum(w[-1] for w in level.mlps)
            skips.append(c_in)
        self.SA_modules = nn.ModuleList(sa)
        n = len(cfg.sa_levels)
        fp = []
        for i, widths in enumerate(cfg.fp_mlps):
            # fp{i} blends the fp{i+1} output (the raw SA output at the
            # top) and concatenates level i's skip features.
            known = cfg.fp_mlps[i + 1][-1] if i < n - 1 else skips[i + 1]
            fp.append(FeaturePropagation(skips[i] + known, widths,
                                         cfg.interp_mode))
        self.FP_modules = nn.ModuleList(fp)

    def forward(self, pointcloud: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                bn_momentum=0.1) -> torch.Tensor:
        xyz = pointcloud[..., :3].float().contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [features]
        for li, sa in enumerate(self.SA_modules):
            nxyz, nfeat = sa(l_xyz[li], l_feats[li], dtype, bn_momentum)
            l_xyz.append(nxyz)
            l_feats.append(nfeat)
        # Coarsest -> finest (pvn3d.py:149-152).
        for li in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[li] = self.FP_modules[li](
                l_xyz[li], l_xyz[li + 1], l_feats[li], l_feats[li + 1], dtype,
                bn_momentum)
        return l_feats[0]
