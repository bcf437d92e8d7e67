"""Depth map <-> point cloud geometry: unprojection and projection.

Port of the JAX package's ``geometry/cloud.py`` (the reference's
``dpt_2_cld`` and ``project_p3d``, basic_utils.py:381-399 and :306-313).
``depth_to_cloud_map`` works on the full pixel grid with a validity mask,
over any leading batch axes, so it runs on the device inside the raw-frame
path; ``depth_to_cloud`` is the host (numpy) form that keeps only valid
pixels.  x = (col - cx) * z / fx and y = (row - cy) * z / fy, in that
order of operations.
"""
from __future__ import annotations

import numpy as np
import torch


def depth_to_cloud_map(depth: torch.Tensor, k: torch.Tensor,
                       cam_scale: float = 1.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unproject (..., H, W) depth maps with (..., 3, 3) intrinsics to
    (..., H, W, 3) camera-frame clouds.

    Returns (cloud_map, valid) with valid = depth > 1e-6 (the reference's
    msk_dp, basic_utils.py:384).
    """
    h, w = depth.shape[-2:]
    z = depth.float() / cam_scale
    k = k.float()
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    fx, fy = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    cx, cy = k[..., 0, 2, None, None], k[..., 1, 2, None, None]
    x = (cols - cx) * z / fx
    y = (rows - cy) * z / fy
    return torch.stack([x, y, z], dim=-1), depth > 1e-6


def depth_to_cloud(depth: np.ndarray, k: np.ndarray, cam_scale: float = 1.0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Host unprojection of the valid pixels of one depth map: (cloud
    (M, 3), choose (M,) flat pixel indices), or (None, None) when no
    pixel has depth (``dpt_2_cld`` semantics)."""
    if depth.ndim > 2:
        depth = depth[..., 0]
    h, w = depth.shape
    msk = depth > 1e-6
    choose = np.flatnonzero(msk.ravel()).astype(np.int64)
    if choose.size == 0:
        return None, None
    z = depth.ravel()[choose].astype(np.float32) / cam_scale
    col = (choose % w).astype(np.float32)
    row = (choose // w).astype(np.float32)
    x = (col - k[0, 2]) * z / k[0, 0]
    y = (row - k[1, 2]) * z / k[1, 1]
    return np.stack([x, y, z], axis=1), choose


def project_points(p3d: torch.Tensor, k: torch.Tensor,
                   cam_scale: float = 1.0) -> torch.Tensor:
    """Project (..., N, 3) camera-frame points through the (3, 3)
    intrinsics ``k`` to int32 pixel coordinates (..., N, 2), rounded half
    to even."""
    uvw = torch.matmul(p3d.float() * cam_scale,
                       torch.as_tensor(k, dtype=torch.float32,
                                       device=p3d.device).T)
    # Sign-preserving divisor guard: the reference divides by z directly,
    # so points behind the camera mirror (negative z) rather than blow up;
    # only |z| ~ 0 is clamped, to keep inf and nan out.
    z = uvw[..., 2:3]
    z = torch.where(z.abs() < 1e-9,
                    torch.where(z < 0, -1e-9, 1e-9).to(z.dtype), z)
    uv = torch.round(uvw[..., :2] / z)
    # Saturate out-of-range coordinates (|z| near 0) as XLA's float to
    # int32 conversion does; a plain cast of them is undefined.
    hi = uv >= 2.0 ** 31
    uv = torch.where(hi, 0.0, uv.clamp(min=-2.0 ** 31)).to(torch.int32)
    return torch.where(hi, torch.iinfo(torch.int32).max, uv)
