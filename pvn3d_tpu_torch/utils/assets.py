"""YCB keypoint assets of the port: per-class mesh keypoints and radii.

A copy of the part of the JAX package's ``utils/assets.py`` that the
serving path reads, over the port's own copy of the asset files
(``pvn3d_tpu_torch/assets/ycb_object_kps/<class>/{farthest,corners}.txt``).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from pvn3d_tpu_torch import config as C


def _kps_path(cls_id: int, name: str) -> str:
    return os.path.join(C.ASSETS_DIR, "ycb_object_kps",
                        C.YCB_CLASSES[cls_id - 1], f"{name}.txt")


@functools.lru_cache(maxsize=None)
def get_kps(cls_id: int) -> np.ndarray:
    """(8, 3) farthest-point keypoints of a YCB class, in meters."""
    return np.loadtxt(_kps_path(cls_id, "farthest"),
                      dtype=np.float32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def get_ctr(cls_id: int) -> np.ndarray:
    """Object center = mean of the bbox corners (basic_utils.py:583)."""
    corners = np.loadtxt(_kps_path(cls_id, "corners"), dtype=np.float32)
    return corners.reshape(-1, 3).mean(axis=0)


def stacked_mesh_kps(n_cls: int = 22) -> np.ndarray:
    """(n_cls, n_kps+1, 3): per-class mesh keypoints + center, row 0 zero."""
    rows = [np.concatenate([get_kps(c), get_ctr(c).reshape(1, 3)], axis=0)
            for c in range(1, n_cls)]
    out = np.stack(rows, axis=0)
    return np.concatenate([np.zeros((1,) + out.shape[1:], np.float32), out],
                          axis=0).astype(np.float32)


def stacked_class_radii() -> np.ndarray:
    """(22,) per-class cluster radii, row 0 unused (common.py:80)."""
    return np.concatenate(
        [[1.0], np.asarray(C.YCB_RADII, np.float32)]).astype(np.float32)
