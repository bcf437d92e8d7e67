"""Farthest-point sampling and index gathering (channels-last).

Port of the JAX package's ``ops/sampling.py``.  ``furthest_point_sample``
is exact serial FPS (``groups=1``) through kernel K1, or the JAX package's
grouped (sharded) FPS (``groups=G > 1``, ``_fps_grouped``): the points
sorted along the widest axis and cut into G equal slabs, each sampled by
its own FPS of m/G (K1 on B*G rows of N/G points).
"""
from __future__ import annotations

import torch

from pvn3d_tpu_torch.ops.kernels.fps import fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int, groups: int = 1,
                          slab_sorted: bool = False) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32: sample 0 is index 0, then the point
    farthest from the picked set, lowest index on ties; points with
    |p|^2 <= 1e-3 are never picked (sampling_gpu.cu:92-110).  ``groups``
    > 1 runs that per slab (``_fps_grouped``); ``slab_sorted`` says the
    input is already slab-major (a previous grouped level's output)."""
    if groups > 1:
        return _fps_grouped(xyz, npoint, groups, slab_sorted)
    return fps(xyz, npoint)


def _fps_grouped(xyz: torch.Tensor, npoint: int, groups: int,
                 slab_sorted: bool) -> torch.Tensor:
    """The JAX package's ``_fps_grouped`` (sampling.py:73-103): a stable
    sort on the widest axis (the first of equal spreads, as ``argmax``),
    G contiguous equal-count slabs, FPS of m/G per slab, slab offsets, and
    the picks mapped back through the sort."""
    b, n, _ = xyz.shape
    g = groups
    if n % g or npoint % g:
        raise ValueError(f"fps groups={g} must divide N={n} and m={npoint}")
    xyz = xyz.float()
    order = None
    if not slab_sorted:
        spread = xyz.amax(dim=1) - xyz.amin(dim=1)              # (B, 3)
        ax = torch.argmax(spread, dim=1)                         # first max
        key = torch.gather(xyz, 2, ax[:, None, None].expand(-1, n, 1))[..., 0]
        order = torch.sort(key, dim=1, stable=True).indices
        xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    local = fps(xyz.reshape(b * g, n // g, 3).contiguous(), npoint // g)
    offsets = torch.arange(g, device=xyz.device, dtype=torch.int32) * (n // g)
    pos = (local.reshape(b, g, npoint // g) + offsets[None, :, None]
           ).reshape(b, npoint)
    if order is None:
        return pos
    return torch.gather(order, 1, pos.long()).to(torch.int32)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, m) -> (B, m, C)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)
