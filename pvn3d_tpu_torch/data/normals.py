"""Surface normals: of an organized depth map on the host, and PCA
normals of an unorganized cloud.

Port of the JAX package's ``data/normals.py``.  The reference runs PCL
NormalEstimation with KSearch(50) per frame on the unorganized cloud
(ycb_dataset.py:147-157); normals only feed the network as 3 input
features, so the replacement is judged by feature quality.

  * ``normals_from_depth_map`` (JAX ``:53-123``): smooth the unprojected
    3-D map, take central-difference tangents, cross them, and orient the
    normal toward the camera.  ``impl="auto"`` runs the C++ twin
    (``native/preprocess.cpp``), as the JAX function does; its plain
    version is the numpy arm (``impl="numpy"``), within 2e-3 of it with
    the same zero mask.  The on-card counterpart is
    ``ops/preprocess.py::normals_from_depth_map``.
  * ``knn_normals`` (JAX ``:26``, scikit-learn's ``NearestNeighbors``):
    PCA normals over each point's k nearest neighbours, the closest match
    to PCL's semantics; exact k-NN in torch, on the CPU or the card.
"""
from __future__ import annotations

import numpy as np
import torch

from pvn3d_tpu_torch.utils.device import resolve_device


def knn_normals(points, k: int = 50, viewpoint=(0.0, 0.0, 0.0),
                device: str | torch.device = "cuda") -> np.ndarray:
    """(n, 3) float32 PCA plane normals of each point's k-NN, oriented to
    the viewpoint, computed on ``device`` (the card unless the CPU is
    asked for).

    Semantics of PCL NormalEstimation + KSearch(k) and of the JAX
    function: the k nearest neighbours (the point itself included) by
    exact float64 direct-form d^2 and ``topk``, in chunks of rows; the
    smallest eigenvector of their float64 covariance
    (``torch.linalg.eigh``), flipped so n . (viewpoint - p) >= 0; rows
    whose normal is not finite get 0.
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float64,
                          device=dev)
    n = len(pts)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    k = min(k, n)
    rows = max(1, (1 << 22) // n)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, rows):
        diff = pts[s:s + rows, None, :] - pts[None, :, :]
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        idx[s:s + rows] = torch.topk(d2, k, dim=1, largest=False).indices
    nbrs = pts[idx]                                   # (n, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    normals = torch.linalg.eigh(cov).eigenvectors[:, :, 0]
    to_view = torch.as_tensor(viewpoint, dtype=torch.float64,
                              device=dev)[None, :] - pts
    flip = (normals * to_view).sum(dim=1) < 0
    normals = torch.where(flip[:, None], -normals, normals)
    normals = torch.where(torch.isfinite(normals).all(dim=1, keepdim=True),
                          normals, torch.zeros_like(normals))
    return normals.float().cpu().numpy()


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
                           depth_jump: float = 0.05,
                           impl: str = "auto") -> np.ndarray:
    """(H, W, 3) float32 unit normals of an (H, W) depth map.

    Central differences of the smoothed 3-D map give the tangents, their
    cross product the normal, oriented so n . p <= 0.  Invalid pixels and
    differences across depth jumps over ``depth_jump`` m give 0.
    ``impl``: "auto" (the C++ twin) or "numpy".
    """
    if impl == "auto":
        from pvn3d_tpu_torch.native.preprocess import \
            normals_from_depth_map_native
        return normals_from_depth_map_native(
            np.asarray(depth).reshape(depth.shape[:2]),
            np.asarray(k, np.float32), cam_scale, smooth, depth_jump)
    if impl != "numpy":
        raise ValueError(f"impl {impl!r}: 'auto' (the C++ twin) or 'numpy'")
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
