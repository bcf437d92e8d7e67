"""Assets of the port: mesh keypoints, corners and radii, LineMOD
diameters, and object meshes read from a dataset checkout.

A copy of the JAX package's ``utils/assets.py`` over the port's own copy
of the asset files (``pvn3d_tpu_torch/assets/{ycb_object_kps,lm_obj_kps}/
<object>/{farthest*,corners}.txt``, ``assets/lm_config/models_info.yml``).
A class is a YCB class id (1-21), a LineMOD object id, or an object name;
``ds_type`` is "ycb" or "linemod".  The YCB-only calls of the serving
path (``get_kps(cls_id)``, ``stacked_mesh_kps(n_cls)``,
``stacked_class_radii()``) keep working: "ycb" is the default.
"""
from __future__ import annotations

import functools
import os
import re

import numpy as np

from pvn3d_tpu_torch import config as C


def _kps_dir(ds_type: str) -> str:
    sub = "ycb_object_kps" if ds_type == "ycb" else "lm_obj_kps"
    return os.path.join(C.ASSETS_DIR, sub)


def _cls_name(cls, ds_type: str) -> str:
    if isinstance(cls, (int, np.integer)):
        if ds_type == "ycb":
            return C.YCB_CLASSES[int(cls) - 1]
        return C.LM_ID2OBJ[int(cls)]
    return cls


@functools.lru_cache(maxsize=None)
def get_kps(cls, kp_type: str = "farthest",
            ds_type: str = "ycb") -> np.ndarray:
    """(n_kps, 3) farthest-point keypoints of an object, in meters;
    ``kp_type`` "farthest" (8) or "farthest4/12/16/20"
    (ycb_dataset.py:263-267)."""
    path = os.path.join(_kps_dir(ds_type), _cls_name(cls, ds_type),
                        f"{kp_type}.txt")
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def get_corners(cls, ds_type: str = "ycb") -> np.ndarray:
    path = os.path.join(_kps_dir(ds_type), _cls_name(cls, ds_type),
                        "corners.txt")
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def get_ctr(cls, ds_type: str = "ycb") -> np.ndarray:
    """Object center = mean of the bbox corners (basic_utils.py:583)."""
    return get_corners(cls, ds_type).mean(axis=0)


def stacked_mesh_kps(n_cls: int = 22, ds_type: str = "ycb",
                     kp_type: str = "farthest") -> np.ndarray:
    """(n_cls, n_kps+1, 3): per-class mesh keypoints + center, row 0 zero
    (cal_frame_poses, pvn3d_eval_utils.py:99-103)."""
    rows = [np.concatenate([get_kps(c, kp_type, ds_type),
                            get_ctr(c, ds_type).reshape(1, 3)], axis=0)
            for c in range(1, n_cls)]
    out = np.stack(rows, axis=0)
    return np.concatenate([np.zeros((1,) + out.shape[1:], np.float32), out],
                          axis=0).astype(np.float32)


def stacked_class_radii(ds_type: str = "ycb", n_cls: int = 22) -> np.ndarray:
    """(n_cls,) per-class cluster radii, row 0 unused (common.py:80); all
    ones for LineMOD."""
    if ds_type == "ycb":
        return np.concatenate(
            [[1.0], np.asarray(C.YCB_RADII, np.float32)]).astype(np.float32)
    return np.ones((n_cls,), np.float32)


@functools.lru_cache(maxsize=None)
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


def load_mesh_points(root: str, cls, ds_type: str = "ycb",
                     max_points: int = 0, seed: int = 0) -> np.ndarray:
    """An object's mesh points from a dataset checkout: YCB
    ``models/<class>/points.xyz``; LineMOD ``models/obj_XX.ply`` vertices
    scaled mm -> m and cut to 2000 points (basic_utils.py:497-519).  Past
    ``max_points``, a subset drawn by ``RandomState(seed)``."""
    if ds_type == "ycb":
        path = os.path.join(root, "models", _cls_name(cls, ds_type),
                            "points.xyz")
        pts = np.loadtxt(path, dtype=np.float32)
    else:
        path = os.path.join(root, "models", "obj_%02d.ply" % int(cls))
        pts = read_ply_vertices(path) / 1000.0
        if max_points <= 0:
            max_points = 2000
    if max_points and len(pts) > max_points:
        rng = np.random.RandomState(seed)
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    return pts.astype(np.float32)


def stacked_mesh_points(root: str, ds_type: str = "ycb", n_cls: int = 22,
                        max_points: int = 2600, seed: int = 0,
                        cls_ids=None) -> tuple:
    """(n_cls, M, 3) padded per-class mesh clouds and their (n_cls, M)
    validity, row 0 empty.  Row i holds class ``cls_ids[i - 1]``
    (default: class i), so a LineMOD object's mesh can sit in row 1."""
    ids = list(range(1, n_cls)) if cls_ids is None else list(cls_ids)
    pts_list = [np.zeros((0, 3), np.float32)] + [
        load_mesh_points(root, c, ds_type=ds_type, max_points=max_points,
                         seed=seed) for c in ids]
    m = max(max(len(p) for p in pts_list), 1)
    out = np.zeros((n_cls, m, 3), np.float32)
    valid = np.zeros((n_cls, m), bool)
    for i, p in enumerate(pts_list):
        out[i, :len(p)] = p
        valid[i, :len(p)] = True
    return out, valid


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """(n, 3) float32 vertex coordinates of an ascii or binary (either
    byte order) PLY file."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            line = line.decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vertex, fmt, props, in_vertex = 0, "ascii", [], False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
        if fmt == "ascii":
            rows = [f.readline().split()[:3] for _ in range(n_vertex)]
            return np.array(rows, dtype=np.float32).reshape(-1, 3)
        endian = ">" if "big_endian" in fmt else "<"
        dt = np.dtype([(n, endian + _PLY_TYPES[t]) for t, n in props])
        data = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float32)
