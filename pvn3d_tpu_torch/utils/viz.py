"""Visualization helpers: pose projection overlays, label colors.

Port of the JAX package's ``utils/viz.py`` (reference:
Basic_Utils.project_p3d / draw_p2ds / get_label_color,
pvn3d/lib/utils/basic_utils.py:306-379), used by the demo to render
predicted poses into the image and by ``tools/check_dataset.py`` for its
overlays.  The JAX module draws a point of radius > 1 with
``cv2.circle(img, centre, r, color, -1)``; ``filled_circle`` rasterises
that circle in numpy, pixel for pixel as cv2 does.
"""
from __future__ import annotations

import functools

import numpy as np


def project_points_np(p3d: np.ndarray, k: np.ndarray,
                      cam_scale: float = 1.0) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) integer pixel coords."""
    p = np.asarray(p3d, np.float64) * cam_scale
    uvw = p @ np.asarray(k, np.float64).T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
    return np.round(uv).astype(np.int32)


def label_color(cls_id: int) -> tuple:
    """Deterministic distinct color per class id (BGR-ish tuple)."""
    rng = np.random.RandomState(cls_id * 7919 + 13)
    c = rng.randint(60, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


@functools.lru_cache(maxsize=None)
def _circle_half_widths(radius: int) -> tuple:
    """Half width of a filled circle's span on each row offset 0..radius.

    cv2's filled ``circle`` at ``LINE_8`` without sub-pixel shift
    (imgproc/src/drawing.cpp ``Circle``) walks one octant with an
    integer midpoint rule and, at each (dx, dy), fills rows cy +- dy over
    cx +- dx and rows cy +- dx over cx +- dy.  The spans on a row share
    its centre, so the row's pixels are those of its widest span.
    """
    half = [0] * (radius + 1)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return tuple(half)


def filled_circle(img: np.ndarray, center, radius: int,
                  color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` in numpy (in
    place): the same pixels, clipped to the image, for any centre."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for off, hw in enumerate(_circle_half_widths(int(radius))):
        x0, x1 = max(cx - hw, 0), min(cx + hw, w - 1)
        if x0 > x1:
            continue
        for y in {cy - off, cy + off}:
            if 0 <= y < h:
                img[y, x0:x1 + 1] = color
    return img


def draw_points(img: np.ndarray, p2ds: np.ndarray, color: tuple,
                radius: int = 1) -> np.ndarray:
    """Draw projected points on a (H, W, 3) uint8 image (in place)."""
    h, w = img.shape[:2]
    ok = (p2ds[:, 0] >= 0) & (p2ds[:, 0] < w) & \
         (p2ds[:, 1] >= 0) & (p2ds[:, 1] < h)
    pts = p2ds[ok]
    if radius <= 1:
        img[pts[:, 1], pts[:, 0]] = color
    else:
        for x, y in pts:
            filled_circle(img, (x, y), radius, color)
    return img


def draw_pose_mesh(img: np.ndarray, mesh_pts: np.ndarray, pose: np.ndarray,
                   k: np.ndarray, cls_id: int = 1,
                   cam_scale: float = 1.0) -> np.ndarray:
    """Project a mesh under ``pose`` and scatter it on the image
    (reference demo.py:122-146 behavior)."""
    cam = mesh_pts @ np.asarray(pose)[:, :3].T + np.asarray(pose)[:, 3]
    p2ds = project_points_np(cam, k, cam_scale)
    return draw_points(img, p2ds, label_color(cls_id))
