"""Raw sensor frames to network inputs, on the device.

Port of the inference half of the JAX package's ``data/device_frame.py``
(the training half, with augmentation and targets, is not ported yet).
The host only decodes images; depth completion, unprojection, normals,
the point subsample and the feature assembly run on the frame's device
over the whole batch at once (reference get_item tail,
ycb_dataset.py:206-306).

The point subsample is a priority top-k: each valid pixel gets a uniform
priority in [1e-4, 1) and the ``n_sample`` largest are kept, a uniform
subset without replacement.  Equal priorities keep the lower pixel index
first (``lax.top_k``'s order), by a stable descending sort.  Priorities
come from a ``torch.Generator`` on the frame's device, or are passed in
(the tests pass the JAX package's own draws).  When fewer than
``n_sample`` pixels are valid, the rest repeat the first selected pixel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from pvn3d_tpu_torch.geometry.cloud import depth_to_cloud_map
from pvn3d_tpu_torch.ops.preprocess import (fill_missing,
                                            normals_from_depth_map)

_PRIORITY_MIN = 1e-4


def draw_priorities(shape, device: torch.device,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Uniform float32 priorities in [1e-4, 1) (the bounds of the JAX
    package's ``jax.random.uniform`` draw)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u * (1.0 - _PRIORITY_MIN) + _PRIORITY_MIN,
                       min=_PRIORITY_MIN)


def build_inference_batch_device(rgb: torch.Tensor, depth: torch.Tensor,
                                 cam_k: torch.Tensor, n_sample: int,
                                 cam_scale: float = 1.0, fill: bool = True,
                                 generator: Optional[torch.Generator] = None,
                                 priorities: Optional[torch.Tensor] = None
                                 ) -> Dict[str, torch.Tensor]:
    """Raw frames -> network inputs, on the device the tensors lie on.

    Args:
      rgb: (B, H, W, 3) 0-255, the dataset's channel order.
      depth: (B, H, W) raw depth in native units (``cam_scale`` per metre).
      cam_k: (B, 3, 3) intrinsics.
      fill: run ip_basic depth completion first (YCB yes, LineMOD no).
      generator: draws the priorities when ``priorities`` is not given
        (None: the device's default generator).
      priorities: (B, H*W) priorities in (0, 1] to use instead of a draw.

    Returns pointcloud (B, N, 9) [xyz | rgb | normal], choose (B, N) int32
    flat pixel indices (ascending), and depth_m (B, H, W), the filled depth
    in metres.
    """
    b, h, w = depth.shape
    p = h * w
    d = fill_missing(depth.float(), cam_scale) if fill else depth
    depth_m = d.float() / cam_scale
    cloud_map, valid_map = depth_to_cloud_map(depth_m, cam_k, 1.0)
    nrm_map = normals_from_depth_map(depth_m, cam_k, 1.0)

    if priorities is None:
        priorities = draw_priorities((b, p), depth.device, generator)
    choose = select_pixels(valid_map.reshape(b, p), priorities, n_sample)
    return {"pointcloud": gather_points(choose, cloud_map, rgb, nrm_map),
            "choose": choose.to(torch.int32), "depth_m": depth_m}


def select_pixels(valid: torch.Tensor, priorities: torch.Tensor,
                  n_sample: int) -> torch.Tensor:
    """The ``n_sample`` valid pixels of highest priority per frame of
    (B, P) masks, as ascending flat indices (B, n_sample) (int64); equal
    priorities keep the lower index first, and a frame with fewer valid
    pixels repeats its first selected pixel."""
    score = torch.where(valid, priorities.float(), -1.0)
    top, sel = torch.sort(score, dim=1, descending=True, stable=True)
    top, sel = top[:, :n_sample], sel[:, :n_sample]
    sel = torch.where(top > 0.0, sel, sel[:, :1])       # under-budget pad
    return torch.sort(sel, dim=1).values


def gather_points(choose: torch.Tensor, cloud_map: torch.Tensor,
                  rgb: torch.Tensor, nrm_map: torch.Tensor) -> torch.Tensor:
    """The (B, N, 9) [xyz | rgb | normal] rows of the (B, H, W, 3) maps
    at the (B, N) flat pixel indices ``choose``."""
    idx = choose[..., None].expand(-1, -1, 3)

    def gather(m):
        return torch.gather(m.reshape(choose.shape[0], -1, 3), 1, idx)
    return torch.cat([gather(cloud_map), gather(rgb.float()),
                      gather(nrm_map)], dim=-1)
