"""Depth-map completion on the host.

Port of the JAX package's ``data/depth_completion.py::fill_missing``
(``:145-169``; the reference's Basic_Utils.fill_missing,
basic_utils.py:436-456, max_depth 3.0): rescale the depth to metres, run
ip_basic's multi-scale fill, scale back.  The JAX module fills with cv2
(or a native C++ twin); here the fill is the port's own
``ops/preprocess.py::fill_in_multiscale`` on a CPU tensor, the same
function the card runs, so the host and the card build the same frame.
The single-scale ``fill_type="fast"`` is not ported (``ROADMAP.md``
queue A, item 9) and raises.
"""
from __future__ import annotations

import numpy as np
import torch

from pvn3d_tpu_torch.ops.preprocess import fill_in_multiscale


def fill_missing(depth: np.ndarray, cam_scale: float = 1.0,
                 fill_type: str = "multiscale") -> np.ndarray:
    """An (H, W) depth map in ``cam_scale`` units per metre, filled, in
    the same units (float32): ip_basic's defaults as the reference calls
    it (max depth 3 m, bilateral blur, no extrapolation)."""
    if fill_type == "fast":
        raise NotImplementedError(
            "fill_type='fast' (ip_basic fill_in_fast) is not ported "
            "(ROADMAP.md queue A, item 9)")
    if fill_type != "multiscale":
        raise ValueError(f"unknown fill_type {fill_type!r}")
    d = depth / cam_scale
    with torch.no_grad():
        filled = fill_in_multiscale(
            torch.from_numpy(np.ascontiguousarray(d, np.float32))[None]
        )[0].numpy()
    return filled * cam_scale
