"""Depth-map completion on the host.

Port of the JAX package's ``data/depth_completion.py::fill_missing``
(``:145-169``; the reference's Basic_Utils.fill_missing,
basic_utils.py:436-456, max depth 3.0): rescale the depth to metres, fill,
scale back.  As in the JAX package, ``impl="auto"`` runs the multi-scale
fill through the C++ twin (``native/preprocess.cpp``, within 1e-4 of
cv2's ip_basic); its plain version, ``impl="torch"``, is the port's
``ops/preprocess.py::fill_in_multiscale`` on a CPU tensor, the function
the card runs in the on-card frame build.  ``fill_type="fast"`` is
ip_basic's single-scale ``fill_in_fast`` (JAX ``:110``), which has no twin
in either package: torch on the CPU with cv2's borders.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pvn3d_tpu_torch.ops.preprocess import (_VALID_EPS, _dilate_cross,
                                            _dilate_full, _erode_full,
                                            _median5, fill_in_multiscale)


def _reflect_taps5(x: torch.Tensor) -> torch.Tensor:
    """The 25 taps of each pixel's 5x5 window of (B, H, W) maps, borders
    mirrored without repeating the edge (cv2's BORDER_REFLECT_101):
    (B, 25, H, W), row-major window order."""
    b, h, w = x.shape
    xp = F.pad(x[:, None], (2, 2, 2, 2), mode="reflect")
    return F.unfold(xp, 5).reshape(b, 25, h, w)


def _bilateral5_cv2(x: torch.Tensor, sigma_color: float,
                    sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter(d=5, sigmaColor, sigmaSpace) of float maps:
    the radius-2 circle, reflect-101 borders, weights
    exp(-dv^2/2sc^2) * exp(-dist^2/2ss^2) (cv2 reads the colour term from
    a 4096-bin table; exact here)."""
    taps = _reflect_taps5(x)
    offs = torch.arange(5, dtype=torch.float32) - 2
    d2 = (offs[:, None] ** 2 + offs[None, :] ** 2).reshape(25, 1, 1)
    sw = torch.where(d2 <= 4.0, torch.exp(-0.5 * d2 / sigma_space ** 2), 0.0)
    dv = taps - x[:, None]
    wt = sw * torch.exp(-0.5 * dv * dv / sigma_color ** 2)
    return (wt * taps).sum(dim=1) / wt.sum(dim=1)


def fill_in_fast(depth: np.ndarray) -> np.ndarray:
    """ip_basic's single-scale fill of an (H, W) depth map in metres at
    its defaults (depth_map_utils_ycb.py:67-132, JAX ``:110-142``; max
    depth 3 m, no extrapolation): invert, one 5x5 cross dilation, a 5x5
    close, small holes from a 7x7 dilation, a 5x5 median, the bilateral
    blur, invert back."""
    max_depth = 3.0
    with torch.no_grad():
        d = torch.from_numpy(np.ascontiguousarray(depth, np.float32))[None]
        d = torch.where(d > _VALID_EPS, max_depth - d, d)
        d = _dilate_cross(d, 5)
        d = _erode_full(_dilate_full(d, 5), 5)           # MORPH_CLOSE
        d = torch.where(d < _VALID_EPS, _dilate_full(d, 7), d)
        d = _bilateral5_cv2(_median5(d), 1.5, 2.0)
        d = torch.where(d > _VALID_EPS, max_depth - d, d)
    return d[0].numpy()


def fill_missing(depth: np.ndarray, cam_scale: float = 1.0,
                 fill_type: str = "multiscale",
                 impl: str = "auto") -> np.ndarray:
    """An (H, W) depth map in ``cam_scale`` units per metre, filled, in
    the same units (float32): ip_basic's defaults as the reference calls
    it (max depth 3 m, bilateral blur, no extrapolation).  The
    multi-scale fill runs the C++ twin (``impl="auto"``) or its torch
    plain version (``impl="torch"``); ``fill_type="fast"`` has one
    implementation."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"impl {impl!r}: 'auto' (the C++ twin) or 'torch'")
    d = depth / cam_scale
    if fill_type == "fast":
        filled = fill_in_fast(d)
    elif fill_type != "multiscale":
        raise ValueError(f"unknown fill_type {fill_type!r}")
    elif impl == "auto":
        from pvn3d_tpu_torch.native.preprocess import \
            fill_in_multiscale_native
        filled = fill_in_multiscale_native(d)
    else:
        with torch.no_grad():
            filled = fill_in_multiscale(torch.from_numpy(
                np.ascontiguousarray(d, np.float32))[None])[0].numpy()
    return filled * cam_scale
