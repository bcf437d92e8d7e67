"""Raw sensor frames to network inputs, on the device.

Port of the JAX package's ``data/device_frame.py``.  The host only
decodes images; depth completion, unprojection, normals, the point
subsample and the feature assembly run on the frame's device over the
whole batch at once (reference get_item tail, ycb_dataset.py:206-306).
The training build (``build_train_batch_device``) adds the augmentation
(``ops/augment_device.py``) and the GT offset targets first and after.

The point subsample is a priority top-k: each valid pixel gets a uniform
priority in [1e-4, 1) and the ``n_sample`` largest are kept, a uniform
subset without replacement.  Equal priorities keep the lower pixel index
first (``lax.top_k``'s order), by a stable descending sort.  Priorities
come from a ``torch.Generator`` on the frame's device, or are passed in
(the tests pass the JAX package's own draws).  When fewer than
``n_sample`` pixels are valid, the rest repeat the first selected pixel.

A training frame's draws come from a CPU ``torch.Generator``, one per
step (``step_generator``): its scalars, and the seeds of its noise and
priority fields, which are counter-based hashes evaluated on the frame's
device (``ops/augment_device.uniform_field``).  So the same generator
builds the same frame on the card and on the CPU, and no device value is
read to decide a branch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pvn3d_tpu_torch.geometry.cloud import depth_to_cloud_map
from pvn3d_tpu_torch.ops import augment_device as aug
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


# ---------------------------------------------------------------------------
# Training path: augmentation and GT targets on the device
# ---------------------------------------------------------------------------

def step_generator(seed: int, step: int) -> torch.Generator:
    """A training step's CPU generator, seeded from (seed, 7919, step) as
    the JAX app folds 7919 and the step into its key."""
    s = int(np.random.SeedSequence((seed, 7919, step)).generate_state(
        1, np.uint64)[0])
    return torch.Generator().manual_seed(s)


def priority_field(seed: int, p: int, device) -> torch.Tensor:
    """(p,) priorities in [1e-4, 1) (``draw_priorities``' bounds) from a
    counter-based field: the same on every device."""
    u = aug.uniform_field(seed, (p,), device)
    return torch.clamp(u * (1.0 - _PRIORITY_MIN) + _PRIORITY_MIN,
                       min=_PRIORITY_MIN)


def build_targets_device(cld: torch.Tensor, labels: torch.Tensor,
                         cls_ids: torch.Tensor, rts: torch.Tensor,
                         mesh_kps: torch.Tensor, mesh_ctrs: torch.Tensor,
                         n_classes: int) -> Dict[str, torch.Tensor]:
    """GT targets of a batch (the twin of ``data/frame.py::
    build_targets``): cld (B, P, 3), labels (B, P), cls_ids (B, I) (0 =
    empty slot), rts (B, I, 3, 4), mesh_kps (B, I, K, 3), mesh_ctrs
    (B, I, 3).  Offsets are point - transformed target at each
    instance's labelled points (ycb_dataset.py:241-278)."""
    b, n_inst = cls_ids.shape
    r = rts[..., :3].float()
    t = rts[..., 3].float()
    kps_cam = torch.einsum("bikc,bidc->bikd", mesh_kps.float(), r) \
        + t[:, :, None, :]
    ctr_cam = torch.einsum("bic,bidc->bid", mesh_ctrs.float(), r) + t
    cls_ids = cls_ids.long()
    valid = cls_ids > 0
    # Label value -> instance row, or -1; empty slots write a spare
    # column that no label reads.
    lut = torch.full((b, n_classes + 1), -1, dtype=torch.long,
                     device=cls_ids.device)
    rows = torch.arange(n_inst, device=cls_ids.device).expand(b, n_inst)
    lut.scatter_(1, torch.where(valid, cls_ids.clamp(0, n_classes - 1),
                                n_classes), rows)
    lab = labels.long()
    inst = torch.gather(lut, 1, lab.clamp(0, n_classes - 1))
    hit = (inst >= 0) & (lab > 0)
    safe = inst.clamp(min=0)
    frames = torch.arange(b, device=cls_ids.device)[:, None]
    kp_t = torch.where(hit[..., None, None],
                       cld[:, :, None, :] - kps_cam[frames, safe], 0.0)
    ctr_t = torch.where(hit[..., None], cld - ctr_cam[frames, safe], 0.0)
    return {
        "cls_ids": cls_ids.to(torch.int32), "rts": rts.float(),
        "kp_3ds": torch.where(valid[..., None, None], kps_cam, 0.0),
        "ctr_3ds": torch.where(valid[..., None], ctr_cam, 0.0),
        "kp_targ_ofst": kp_t.float(), "ctr_targ_ofst": ctr_t[:, :, None, :],
    }


def draw_train_frame(gen: torch.Generator, dataset: str = "ycb") -> Dict:
    """One training frame's draws, in a fixed order whatever applies:
    the jitter, the noise stack, the again-gate, the second noise stack,
    the priority seed."""
    draw_noise = (aug.draw_noise_ycb if dataset == "ycb"
                  else aug.draw_noise_lm)
    return {"jitter": aug.draw_color_jitter(gen), "noise": draw_noise(gen),
            "again_u": aug._u(gen), "noise2": draw_noise(gen),
            "priority_seed": aug.draw_seed(gen)}


def augment_train_frame(rgb, depth, label_map, back_rgb, back_depth,
                        back_label, is_syn: bool, do_jitter: bool,
                        draws: Dict, dataset: str = "ycb",
                        bgr_flip: bool = False):
    """One frame's (rgb, depth) after the reference's augmentation head
    (ycb_dataset.py:190-199 + :109-177; linemod_dataset.py:222-260):
    jitter where ``do_jitter``, the LineMOD BGR flip, and for synthetic
    frames the noise stack, the real-background paste and, at p 0.2, the
    noise stack again."""
    noise = aug.rgb_add_noise_ycb if dataset == "ycb" else \
        aug.rgb_add_noise_lm
    rgb = aug.color_jitter(rgb, draws["jitter"]) if do_jitter \
        else rgb.float()
    if bgr_flip:
        rgb = torch.flip(rgb, [-1])
        back_rgb = torch.flip(back_rgb, [-1])
    if is_syn:
        rgb = noise(rgb, draws["noise"])
        rgb, depth = aug.add_real_back(rgb, label_map, depth, back_rgb,
                                       back_depth, back_label)
        if draws["again_u"] > 0.8:
            rgb = noise(rgb, draws["noise2"])
    return rgb, depth


def _host_bools(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, bool).reshape(-1)


def build_train_batch_device(raw: Dict, generator: torch.Generator,
                             n_sample: int, n_classes: int,
                             fill: bool = True,
                             dataset: str = "ycb", augment: bool = True,
                             priorities: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
    """A training batch from raw frames, on the device ``raw["depth"]``
    lies on.

    ``raw`` holds (B, ...) rgb, depth (metres, as both datasets' raw
    items carry it), label_map, cam_k, cls_ids, rts, mesh_kps, mesh_ctrs,
    back_rgb, back_depth, back_label as tensors, and is_syn, do_jitter as
    host arrays (a tensor is read to the host).  LineMOD frames take the BGR
    flip after the jitter.  ``priorities`` (B, H*W) replace the drawn
    ones (tests pass the JAX package's).  Returns the host build's sample
    fields: pointcloud, rgb, choose, labels and the targets."""
    depth = raw["depth"]
    dev = depth.device
    b, h, w = depth.shape
    is_syn = _host_bools(raw["is_syn"])
    do_jitter = _host_bools(raw.get("do_jitter", np.ones(b, bool)))
    frames = [draw_train_frame(generator, dataset) for _ in range(b)]
    rgbs, depths = [], []
    for i in range(b):
        rgb_i = raw["rgb"][i].float()
        depth_i = depth[i].float()
        if augment:
            rgb_i, depth_i = augment_train_frame(
                rgb_i, depth_i, raw["label_map"][i], raw["back_rgb"][i],
                raw["back_depth"][i].float(), raw["back_label"][i],
                bool(is_syn[i]), bool(do_jitter[i]), frames[i], dataset,
                bgr_flip=dataset == "linemod")
        elif dataset == "linemod":
            rgb_i = torch.flip(rgb_i, [-1])
        rgbs.append(rgb_i)
        depths.append(depth_i)
    rgb = torch.stack(rgbs)
    if priorities is None:
        priorities = torch.stack([priority_field(f["priority_seed"], h * w,
                                                 dev) for f in frames])
    built = build_inference_batch_device(
        rgb, torch.stack(depths), raw["cam_k"], n_sample, fill=fill,
        priorities=torch.as_tensor(priorities, device=dev))
    choose = built["choose"]
    labels = torch.gather(raw["label_map"].reshape(b, h * w).long(), 1,
                          choose.long()).to(torch.int32)
    sample = {"pointcloud": built["pointcloud"], "rgb": rgb,
              "choose": choose, "labels": labels}
    sample.update(build_targets_device(
        built["pointcloud"][..., :3], labels, raw["cls_ids"], raw["rts"],
        raw["mesh_kps"], raw["mesh_ctrs"], n_classes))
    return sample


def build_train_frame_device(raw_frame: Dict, generator: torch.Generator,
                             n_sample: int, n_classes: int,
                             **kw) -> Dict[str, torch.Tensor]:
    """One training frame (unbatched arrays): the batch of one."""
    batch = {k: (v[None] if torch.is_tensor(v) else np.asarray(v)[None])
             for k, v in raw_frame.items()}
    out = build_train_batch_device(batch, generator, n_sample, n_classes,
                                   **kw)
    return {k: v[0] for k, v in out.items()}
