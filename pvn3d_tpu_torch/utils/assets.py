"""Assets of the port: YCB mesh keypoints and radii, LineMOD diameters.

A copy of the part of the JAX package's ``utils/assets.py`` that the
serving and scoring paths read, over the port's own copy of the asset
files (``pvn3d_tpu_torch/assets/ycb_object_kps/<class>/{farthest,
corners}.txt``, ``assets/lm_config/models_info.yml``).
"""
from __future__ import annotations

import functools
import os
import re

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


def lm_diameters() -> dict:
    """LineMOD object diameters in mm by object id, from models_info.yml
    (the reference reads it with yaml, common.py:131-133; the file is flat
    enough to read line by line)."""
    out = {}
    with open(os.path.join(C.ASSETS_DIR, "lm_config", "models_info.yml")) as f:
        for line in f:
            m = re.match(r"^(\d+):.*?diameter:\s*([0-9.eE+-]+)", line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out
