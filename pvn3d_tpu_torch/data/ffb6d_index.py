"""FFB6D's neighbour index, built on the device per frame.

The source builds it in the CPU data loader with a KD-tree
(``datasets/ycb/ycb_dataset.py``, ``DP.knn_search``); here every search is
``ops.kernels.knn.knn`` on the frame's device.  With ``P0`` the sample in its
random order and ``P{i+1}`` the first ``|Pi| / r`` rows of ``Pi`` (r =
``sub_sampling_ratio``), and ``M_s`` the cloud map at pixels
``[::s, ::s]`` (holes at the origin, as in the source):

* ``nei[i]``: the k-NN of each point of ``Pi`` within ``Pi`` (i = 0..3);
  ``sub[i] = nei[i][:, :|P{i+1}|]``, the pooling neighbourhoods of the
  kept points;
* ``interp[i]``: the 1-NN in ``P{i+1}`` of each point of ``Pi``;
* ``r2p_ds[i]``: the k-NN in ``M_{ds_strides[i]}`` of each point of
  ``P{i+1}``; ``p2r_ds[i]``: the 1-NN in ``P{i+1}`` of each pixel of that
  map;
* ``r2p_up[j]``: the k-NN in ``M_{up_strides[j]}`` of each point of
  ``P{3-j}``; ``p2r_up[j]``: the 1-NN in ``P{3-j}`` of each pixel of that
  map (j = 0..2).

22 searches (4 + 4 + 4 + 4 + 3 + 3).  Only each row's neighbour set
matters downstream (max and softmax pooling ignore order).  Every size is
a shape, so the build reads nothing back to the host.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from pvn3d_tpu_torch.ops.kernels.knn import knn


def level_sizes(n_points: int, ratios) -> List[int]:
    """|P0| .. |P4|: each level the first 1 / ratio of the one before."""
    sizes = [n_points]
    for r in ratios:
        sizes.append(sizes[-1] // r)
    return sizes


def strided_map(cloud_map: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, 3) -> the (B, H/s * W/s, 3) points at pixels [::s, ::s]."""
    m = cloud_map[:, ::stride, ::stride]
    return m.reshape(m.shape[0], -1, 3).contiguous()


def searches(xyz: torch.Tensor, cloud_map: torch.Tensor, cfg):
    """The 22 searches of ``build_index`` in order, as (set name, query
    (B, Q, 3), candidates (B, C, 3), k); then the levels and the maps."""
    rl = cfg.randla
    k = rl.k_n
    xyz = xyz.float().contiguous()
    sizes = level_sizes(xyz.shape[1], rl.sub_sampling_ratio)
    levels = [xyz[:, :n] for n in sizes]
    maps = {s: strided_map(cloud_map.float(), s)
            for s in sorted(set(cfg.ds_strides) | set(cfg.up_strides))}
    out = []
    for i, s in enumerate(cfg.ds_strides):
        pts, sub_pts = levels[i], levels[i + 1]
        out += [("nei", pts, pts, k), ("interp", pts, sub_pts, 1),
                ("r2p_ds", sub_pts, maps[s], k),
                ("p2r_ds", maps[s], sub_pts, 1)]
    n_ds = len(cfg.ds_strides)
    for j, s in enumerate(cfg.up_strides):
        pts = levels[n_ds - j - 1]
        out += [("r2p_up", pts, maps[s], k), ("p2r_up", maps[s], pts, 1)]
    return out, levels, maps


def build_index(xyz: torch.Tensor, cloud_map: torch.Tensor, cfg) -> Dict:
    """The index of (B, N, 3) sampled points in their random order and
    the (B, H, W, 3) cloud map, for ``cfg`` (``config.FFB6DConfig``).
    Returns lists of int32 tensors: ``nei`` (B, |Pi|, k), ``sub``
    (B, |P{i+1}|, k), ``interp`` (B, |Pi|), ``r2p_ds`` (B, |P{i+1}|, k),
    ``p2r_ds`` (B, pixels), ``r2p_up`` (B, |P{3-j}|, k), ``p2r_up``
    (B, pixels); and the float32 coordinates they index: ``xyz``
    (P0 .. P4) and ``maps`` ({stride: (B, H/s * W/s, 3)})."""
    todo, levels, maps = searches(xyz, cloud_map, cfg)
    idx: Dict = {name: [] for name in ("nei", "sub", "interp", "r2p_ds",
                                       "p2r_ds", "r2p_up", "p2r_up")}
    for name, query, cand, k in todo:
        found = knn(query, cand, k)
        if name == "nei":
            i = len(idx["nei"])
            idx["sub"].append(found[:, :levels[i + 1].shape[1]])
        idx[name].append(found if k > 1 else found[..., 0])
    idx["xyz"] = levels
    idx["maps"] = maps
    return idx
