"""Inputs and weights made from the run's seed: the raw RGB-D frame pool of
the serving mixes, the training batch pool, and the network's weights.

The frames follow ``data/synthetic.py::synth_sensor_frame`` (a copy of
the JAX package's raw-pipeline frame), generalised: a slanted table plane
with 3-6 boxes or domes on it, 2 mm depth noise, ~5% dropout holes, as
uint8 RGB and uint16 depth in the camera's units, the way a sensor hands
them over; made on the card in one batch.  The training batches follow
``data/synthetic.py::synthetic_batch`` (clustered objects in a uniform
scatter, their keypoint and centre offset targets), made on the card.
The weights follow ``utils/weights.py::seeded_state_dict``'s rules
(normal with std sqrt(1/fan_in) for conv and dense weights, other biases
normal * 0.01, BN at identity, PReLU slopes 0.25), drawn on the card in
one call.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _generator(seed: int, stream: int, device) -> torch.Generator:
    s = int(np.random.SeedSequence((seed, stream)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def state_dict(model: torch.nn.Module, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """Weights for ``model``'s state dict keys (shapes read from a model
    that may live on the meta device), made on ``device``."""
    modules = dict(model.named_modules())
    shapes = {k: (tuple(t.shape), t.dtype)
              for k, t in model.state_dict().items()}
    drawn = [k for k, (shape, dt) in shapes.items() if dt.is_floating_point
             and not isinstance(modules[k.rsplit(".", 1)[0]],
                                torch.nn.modules.batchnorm._BatchNorm)
             and type(modules[k.rsplit(".", 1)[0]]).__name__ != "PReLU"]
    total = sum(int(np.prod(shapes[k][0])) for k in drawn)
    flat = torch.randn(total, generator=_generator(seed, 0, device),
                       device=device)
    out, at = {}, 0
    for k, (shape, dt) in shapes.items():
        owner, leaf = k.rsplit(".", 1)
        if k in drawn:
            n = int(np.prod(shape))
            v = flat[at:at + n].reshape(shape)
            at += n
            scale = (np.sqrt(1.0 / int(np.prod(shape[1:])))
                     if len(shape) > 1 else 0.01)
            out[k] = v * float(np.float32(scale))
        elif type(modules[owner]).__name__ == "PReLU":
            out[k] = torch.full(shape, 0.25, device=device)
        else:
            fill = 1 if leaf in ("weight", "running_var") else 0
            out[k] = torch.full(shape, fill, dtype=dt, device=device)
    return out


def raw_frames(seed: int, mix: Dict, config: Dict, device) -> List[Dict]:
    """The mix's pool of raw frames, made on ``device`` in one batch and
    handed over as host numpy: rgb (1, H, W, 3) uint8, depth (1, H, W)
    uint16 in ``cam_scale`` units a metre, cam_k (1, 3, 3) float32."""
    model = config["program"]["model"]
    h, w = model["image_height"], model["image_width"]
    n = mix["pool"]
    g = _generator(seed, 1, device)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, None]
    rows = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    tilt = uni((n, 2, 1, 1), -mix["tilt_m"], mix["tilt_m"])
    d = (uni((n, 1, 1), *mix["plane_m"]) + tilt[:, 0] * (cols / w - 0.5)
         + tilt[:, 1] * (rows / h - 0.5))
    rgb = torch.randint(60, 200, (n, h, w, 3), generator=g, device=device
                        ).float()
    lo, hi = mix["objects"]
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    for o in range(hi):
        cu = uni((n, 1, 1), 0.15, 0.85) * w
        cv = uni((n, 1, 1), 0.15, 0.85) * h
        hu = uni((n, 1, 1), *mix["half_size_px"])
        hv = uni((n, 1, 1), *mix["half_size_px"])
        height = uni((n, 1, 1), *mix["height_m"])
        colour = torch.randint(0, 256, (n, 1, 1, 3), generator=g,
                               device=device).float()
        box = uni((n, 1, 1), 0.0, 1.0) < 0.5          # else a dome
        r2 = ((cols - cu) / hu) ** 2 + ((rows - cv) / hv) ** 2
        in_box = ((cols - cu).abs() < hu) & ((rows - cv).abs() < hv)
        inside = torch.where(box, in_box, r2 < 1.0) & (o < count)[:, None,
                                                                  None]
        top = d - height * torch.where(
            box, 1.0, torch.sqrt(torch.clamp(1.0 - r2, min=0.0)))
        d = torch.where(inside, torch.minimum(d, top), d)
        rgb = torch.where(inside[..., None], colour, rgb)
    d = d + mix["noise_m"] * torch.randn((n, h, w), generator=g,
                                         device=device)
    d = torch.where(uni((n, h, w), 0.0, 1.0) < mix["dropout"], 0.0, d)
    rgb = torch.clamp(rgb + 8.0 * torch.randn(rgb.shape, generator=g,
                                              device=device), 0, 255)
    depth = torch.round(torch.clamp(d, min=0.0) * config["cam_scale"])
    rgb = rgb.to(torch.uint8).cpu().numpy()
    depth = depth.to(torch.int32).cpu().numpy().astype(np.uint16)
    k = np.asarray(config["camera_k"], np.float32)[None]
    return [{"rgb": rgb[i:i + 1], "depth": depth[i:i + 1], "cam_k": k}
            for i in range(n)]


def priorities(seed: int, n: int, pixels: int, device) -> torch.Tensor:
    """(n, pixels) sampling priorities in [1e-4, 1), one row a frame."""
    u = torch.rand((n, pixels), generator=_generator(seed, 2, device),
                   device=device)
    return torch.clamp(u * (1.0 - 1e-4) + 1e-4, min=1e-4)


def train_batches(seed: int, mix: Dict, config: Dict, device) -> List[Dict]:
    """The mix's pool of global training batches on ``device``: pointcloud
    (B, N, 9), rgb (B, H, W, 3) in [0, 1), choose (B, N), labels (B, N),
    kp_targ_ofst (B, N, n_kps, 3), ctr_targ_ofst (B, N, 1, 3)."""
    model = config["program"]["model"]
    b, n = mix["batch"], model["n_sample_points"]
    h, w = model["image_height"], model["image_width"]
    n_kps, n_cls = model["n_keypoints"], model["n_classes"]
    n_obj = mix["objects"]
    per = n // (2 * n_obj)
    g = _generator(seed, 3, device)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    pool = []
    for _ in range(mix["pool"]):
        xyz = uni((b, n, 3), -0.6, 0.6) + torch.tensor([0, 0, 1.0],
                                                       device=device)
        labels = torch.zeros((b, n), dtype=torch.int32, device=device)
        kp_t = torch.zeros((b, n, n_kps, 3), device=device)
        ctr_t = torch.zeros((b, n, 1, 3), device=device)
        cls = torch.randint(1, n_cls, (b, n_obj), generator=g, device=device,
                            dtype=torch.int32)
        for o in range(n_obj):
            sl = slice(o * per, (o + 1) * per)
            centre = uni((b, 1, 3), -0.4, 0.4) + torch.tensor(
                [0, 0, 1.0], device=device)
            pts = centre + 0.03 * torch.randn((b, per, 3), generator=g,
                                              device=device)
            xyz[:, sl] = pts
            labels[:, sl] = cls[:, o:o + 1]
            kps = centre + uni((b, n_kps, 3), -0.05, 0.05)
            kp_t[:, sl] = kps[:, None] - pts[:, :, None]
            ctr_t[:, sl, 0] = centre - pts
        pool.append({
            "pointcloud": torch.cat([xyz, uni((b, n, 6), 0.0, 1.0)], -1),
            "rgb": uni((b, h, w, 3), 0.0, 1.0),
            "choose": torch.randint(0, h * w, (b, n), generator=g,
                                    device=device, dtype=torch.int32),
            "labels": labels, "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t})
    return pool
