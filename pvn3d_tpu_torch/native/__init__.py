"""Host-side C++ components: the preprocessing twins and offline FPS.

The port's counterpart of the JAX package's ``native/`` (``__init__.py``
and ``preprocess.py``), with its own copies of the sources
(``preprocess.cpp``, ``fps.cpp``).  ``build_library`` compiles a source at
first use with one fixed command, ``g++ -O3 -fopenmp -shared -fPIC``, into
``<checkout>/build/native/`` (listed in ``.gitignore``), named by a hash
of the source and the command, and the wrappers load it with ``ctypes``.
Spawned loader workers and parallel test processes may build at once:
each compiles to a file of its own pid and ``os.replace``s it into place.
Unlike the JAX package's loaders, which return None and fall back to
numpy, a failed build raises with the compiler's error output; nothing
falls back quietly.  OpenMP runs ``PVN3D_NATIVE_THREADS`` threads, 1 by
default (loader workers are processes of their own).

``farthest_point_sampling`` picks mesh keypoints for
``tools/gen_obj_info.py`` through ``pvn3d_fps`` / ``pvn3d_fps_center``
(``impl="auto"``), or through ``_fps``, their plain numpy version
(``impl="numpy"``; the JAX package's ``_fps_numpy`` and
``_fps_center_numpy`` as one loop).  Both pick the same indices.  The
reference builds its offline FPS as a cffi extension
(pvn3d/lib/utils/dataset_tools/fps/) and seeds the start with
``srand(time(0))``; here the start is drawn from an explicit seed.  The
network's FPS on the card is K1 (``ops/kernels/fps.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Optional

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(NATIVE_DIR)),
                         "build", "native")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def build_library(source: str) -> str:
    """The path of ``source``'s shared library under ``BUILD_DIR``,
    compiled first when it is missing.  Raises ``RuntimeError`` with the
    compiler's output when the build fails or the compiler cannot run."""
    cmd = [CXX, *CXX_FLAGS]
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(cmd).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    target = os.path.join(BUILD_DIR,
                          f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd += [source, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build: cannot run {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def load_library(name: str) -> ctypes.CDLL:
    """``<name>.cpp`` of this package, built and loaded once a process."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build_library(
            os.path.join(NATIVE_DIR, f"{name}.cpp")))
    return _libs[name]


def _fps_library() -> ctypes.CDLL:
    lib = load_library("fps")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32 = ctypes.c_int32
    lib.pvn3d_fps.argtypes = [f32p, i32, i32, i32, i32p]
    lib.pvn3d_fps_center.argtypes = [f32p, i32, i32, i32p]
    lib.pvn3d_fps.restype = lib.pvn3d_fps_center.restype = None
    return lib


def _fps(pts: np.ndarray, sn: int, start: int,
         min_dist: np.ndarray) -> np.ndarray:
    """Greedy FPS from ``start``, the running minimum distance seeded with
    ``min_dist`` (inf for a seeded start, the centre distances for
    ``init_center``)."""
    min_dist = min_dist.astype(np.float32)
    idxs = np.zeros(sn, np.int32)
    cur = start
    for s in range(sn):
        idxs[s] = cur
        min_dist[cur] = -1.0
        if s == sn - 1:
            break
        d = np.sum((pts - pts[cur]) ** 2, axis=1)
        sel = min_dist >= 0
        np.minimum(min_dist, d, where=sel, out=min_dist)
        cur = int(np.argmax(np.where(sel, min_dist, -1.0)))
    return idxs


def fps_indices(pts: np.ndarray, sn: int, init_center: bool = False,
                seed: Optional[int] = 0, impl: str = "auto") -> np.ndarray:
    """The (sn,) int32 indices FPS picks from a (pn, 3) cloud:
    ``impl="auto"`` through the C++ twin, ``"numpy"`` through ``_fps``.

    Semantics of the reference wrapper (fps/fps_utils.py:8-23): the start
    is ``RandomState(seed).randint(pn)`` (index 0 for ``seed=None``), or,
    with ``init_center``, the point farthest from the bbox center, whose
    distances seed the running minimum.
    """
    if impl not in ("auto", "numpy"):
        raise ValueError(f"impl {impl!r}: 'auto' (the C++ twin) or 'numpy'")
    pts = np.ascontiguousarray(pts, np.float32)
    pn = len(pts)
    if pts.ndim != 2 or pts.shape[1] != 3 or pn == 0 or sn < 0:
        raise ValueError(f"FPS takes a non-empty (pn, 3) cloud and sn >= 0;"
                         f" got {pts.shape} and sn {sn}")
    start = 0
    if not init_center and seed is not None:
        start = int(np.random.RandomState(seed).randint(pn))
    if impl == "auto":
        lib = _fps_library()
        idxs = np.zeros(sn, np.int32)
        if init_center:
            lib.pvn3d_fps_center(pts, pn, sn, idxs)
        else:
            lib.pvn3d_fps(pts, pn, sn, start, idxs)
        return idxs
    if init_center:
        ctr = (pts.max(axis=0) + pts.min(axis=0)) / 2.0
        min_dist = np.sum((pts - ctr) ** 2, axis=1)
        start = int(np.argmax(min_dist))
    else:
        min_dist = np.full(pn, np.inf, np.float32)
    return _fps(pts, sn, start, min_dist)


def farthest_point_sampling(pts: np.ndarray, sn: int,
                            init_center: bool = False,
                            seed: Optional[int] = 0,
                            impl: str = "auto") -> np.ndarray:
    """Select ``sn`` FPS points from a (pn, 3) cloud; returns their coords
    (``fps_indices`` says which)."""
    pts = np.ascontiguousarray(pts, np.float32)
    return pts[fps_indices(pts, sn, init_center, seed, impl)]
