"""Rigid-transform estimation (batched, float32).

Port of the JAX package's ``geometry/se3.py``: Umeyama without scale and
with the reflection fix (basic_utils.py:60-74 of the reference).  Poses are
``(..., 3, 4)`` tensors ``[R | t]``.  The contractions are tiny; they run
in float32 on whatever device the inputs lie on (TF32 is off for matmuls,
``utils.device.disable_tf32``).
"""
from __future__ import annotations

from typing import Optional

import torch


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


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 4) poses to (..., N, 3) points."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return torch.matmul(pts, r.transpose(-1, -2)) + t[..., None, :]


def compose_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack rotation (..., 3, 3) and translation (..., 3) into (..., 3, 4)."""
    return torch.cat([r, t[..., :, None]], dim=-1)
