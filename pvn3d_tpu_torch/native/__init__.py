"""Host-side offline farthest point sampling.

The numpy form of the JAX package's ``native/__init__.py``
(``_fps_numpy`` ``:65`` and ``_fps_center_numpy`` ``:82``, one loop here
as ``_fps``; ``farthest_point_sampling`` ``:106``), which the JAX package
runs when its C++ twin (``native/fps.cpp``, loaded by ctypes) does not
build.  Both forms pick the same indices; the C++ twin is ``ROADMAP.md``
queue A, item 9.  The reference builds its offline FPS as a cffi extension
(pvn3d/lib/utils/dataset_tools/fps/) and seeds the start with
``srand(time(0))``; here the start is drawn from an explicit seed.
``tools/gen_obj_info.py`` picks mesh keypoints with it; the on-card FPS
of the network is K1 (``ops/kernels/fps.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


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


def farthest_point_sampling(pts: np.ndarray, sn: int,
                            init_center: bool = False,
                            seed: Optional[int] = 0) -> np.ndarray:
    """Select ``sn`` FPS points from a (pn, 3) cloud; returns their coords.

    Semantics of the reference wrapper (fps/fps_utils.py:8-23): the start
    is ``RandomState(seed).randint(pn)`` (index 0 for ``seed=None``), or,
    with ``init_center``, the point farthest from the bbox center, whose
    distances seed the running minimum.
    """
    pts = np.ascontiguousarray(pts, np.float32)
    pn = len(pts)
    if init_center:
        ctr = (pts.max(axis=0) + pts.min(axis=0)) / 2.0
        min_dist = np.sum((pts - ctr) ** 2, axis=1)
        start = int(np.argmax(min_dist))
    else:
        min_dist = np.full(pn, np.inf, np.float32)
        start = int(np.random.RandomState(seed).randint(pn)) \
            if seed is not None else 0
    return pts[_fps(pts, sn, start, min_dist)]
