"""ctypes wrappers of the preprocessing twins (``native/preprocess.cpp``).

The port's counterpart of the JAX package's ``native/preprocess.py``:
``fill_in_multiscale_native`` (``pvn3d_fill_multiscale``) and
``normals_from_depth_map_native`` (``pvn3d_normals_from_depth``), which
``data/depth_completion.py::fill_missing`` and
``data/normals.py::normals_from_depth_map`` run under ``impl="auto"``.
The library is built at first use (``native.build_library``); a failed
build raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from pvn3d_tpu_torch.native import load_library

# ip_basic's settings as ``fill_missing`` runs them (max depth 3 m, bins at
# 1 and 2 m, no extrapolation, the bilateral blur: mode 2 of the C ABI).
FILL_MAX_DEPTH, FILL_NEAR_BIN, FILL_MED_BIN = 3.0, 1.0, 2.0
FILL_EXTRAPOLATE, FILL_BLUR_BILATERAL = 0, 2


def _library() -> ctypes.CDLL:
    lib = load_library("preprocess")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32, f32 = ctypes.c_int32, ctypes.c_float
    lib.pvn3d_fill_multiscale.argtypes = [
        f32p, i32, i32, f32, f32, f32, i32, i32, f32p]
    lib.pvn3d_normals_from_depth.argtypes = [
        f32p, i32, i32, f32p, f32, i32, f32, f32p]
    lib.pvn3d_fill_multiscale.restype = None
    lib.pvn3d_normals_from_depth.restype = None
    return lib


def _depth_map(depth: np.ndarray) -> np.ndarray:
    d = np.ascontiguousarray(depth, np.float32)
    if d.ndim != 2:
        raise ValueError(f"depth must be (H, W), got {d.shape}")
    return d


def fill_in_multiscale_native(depth: np.ndarray) -> np.ndarray:
    """ip_basic's multi-scale fill of an (H, W) depth map in metres
    (float32 out) at the ``FILL_*`` settings."""
    lib = _library()
    d = _depth_map(depth)
    out = np.empty_like(d)
    lib.pvn3d_fill_multiscale(d, d.shape[0], d.shape[1], FILL_MAX_DEPTH,
                              FILL_NEAR_BIN, FILL_MED_BIN, FILL_EXTRAPOLATE,
                              FILL_BLUR_BILATERAL, out)
    return out


def normals_from_depth_map_native(depth: np.ndarray, k: np.ndarray,
                                  cam_scale: float = 1.0, smooth: int = 2,
                                  depth_jump: float = 0.05) -> np.ndarray:
    """(H, W, 3) float32 normals of an (H, W) depth map, the twin of
    ``data/normals.py::normals_from_depth_map(impl="numpy")``."""
    lib = _library()
    d = _depth_map(depth)
    km = np.ascontiguousarray(k, np.float32).reshape(9)
    out = np.empty((d.shape[0], d.shape[1], 3), np.float32)
    lib.pvn3d_normals_from_depth(d, d.shape[0], d.shape[1], km, cam_scale,
                                 smooth, depth_jump, out)
    return out
