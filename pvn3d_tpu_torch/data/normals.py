"""Surface normals of an organized depth map, on the host.

Port of the numpy arm of the JAX package's ``data/normals.py``
(``normals_from_depth_map``, ``:53-123``).  The reference runs PCL
NormalEstimation with KSearch(50) per frame on the unorganized cloud
(ycb_dataset.py:147-157); normals only feed the network as 3 input
features, so the replacement is judged by feature quality: smooth the
unprojected 3-D map, take central-difference tangents, cross them, and
orient the normal toward the camera.

The JAX function's ``impl="auto"`` prefers a native C++ twin
(``pvn3d_tpu/native/``); that host code and the scikit-learn
``knn_normals`` oracle are not ported (``ROADMAP.md`` queue A, items 9
and 10).  The
on-card twin is ``ops/preprocess.py::normals_from_depth_map``.
"""
from __future__ import annotations

import numpy as np


def _box_blur(x: np.ndarray, r: int) -> np.ndarray:
    """Separable box blur with edge clamping."""
    if r <= 0:
        return x
    pad = np.pad(x, ((r, r), (r, r)) + ((0, 0),) * (x.ndim - 2), mode="edge")
    c = np.cumsum(pad, axis=0)
    c = np.concatenate([c[:1] * 0, c], axis=0)
    x = (c[2 * r + 1:] - c[:-2 * r - 1]) / (2 * r + 1)
    c = np.cumsum(x, axis=1)
    c = np.concatenate([c[:, :1] * 0, c], axis=1)
    return (c[:, 2 * r + 1:] - c[:, :-2 * r - 1]) / (2 * r + 1)


def normals_from_depth_map(depth: np.ndarray, k: np.ndarray,
                           cam_scale: float = 1.0, smooth: int = 2,
                           depth_jump: float = 0.05) -> np.ndarray:
    """(H, W, 3) float32 unit normals of an (H, W) depth map.

    Central differences of the smoothed 3-D map give the tangents, their
    cross product the normal, oriented so n . p <= 0.  Invalid pixels and
    differences across depth jumps over ``depth_jump`` m give 0.
    """
    h, w = depth.shape[:2]
    z = np.float32(depth).reshape(h, w) / cam_scale
    valid = z > 1e-6
    cols = np.arange(w, dtype=np.float32)[None, :]
    rows = np.arange(h, dtype=np.float32)[:, None]
    x = (cols - k[0, 2]) * z / k[0, 0]
    y = (rows - k[1, 2]) * z / k[1, 1]
    p = np.stack([x, y, z], axis=-1)

    if smooth:
        zs = _box_blur(np.where(valid, z, 0.0)[..., None], smooth)[..., 0]
        ws = _box_blur(valid.astype(np.float32)[..., None], smooth)[..., 0]
        z_sm = np.where(ws > 1e-6, zs / np.maximum(ws, 1e-6), z)
        p = np.stack([(cols - k[0, 2]) * z_sm / k[0, 0],
                      (rows - k[1, 2]) * z_sm / k[1, 1], z_sm], axis=-1)

    def diff(a, axis):
        fwd = np.roll(a, -1, axis=axis) - a
        bwd = a - np.roll(a, 1, axis=axis)
        return (fwd + bwd) * 0.5

    du = diff(p, 1)
    dv = diff(p, 0)
    jump_u = np.abs(diff(z[..., None], 1)[..., 0]) > depth_jump
    jump_v = np.abs(diff(z[..., None], 0)[..., 0]) > depth_jump
    n = np.cross(dv, du)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0)
    flip = np.sum(n * p, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    bad = (~valid) | jump_u | jump_v
    n[bad] = 0.0
    return n.astype(np.float32)
