"""Training-time RGB / scene augmentation on the device, in torch.

Port of the JAX package's ``ops/augment_device.py``, the on-device twins
of the host stack (``data/augment.py``; reference ycb_dataset.py:109-177,
linemod_dataset.py:129-150).  As there, augmentation is random noise
whose contract is the distribution, and the realisation differs from the
cv2 host path on purpose: a float HSV round trip, an analytic line kernel
for the motion blur, edge-replicated borders.

The JAX functions compute both sides of every "maybe" and select, because
they trace under ``jit``.  Here each function is split into a ``draw_*``
that takes a frame's scalars from a CPU ``torch.Generator`` (so no device
value is read) and an apply that takes the drawn values and branches in
Python.  Image-size noise comes from ``normal_field``: a counter-based
hash of (seed, element) evaluated on the image's device, its seed drawn
from the generator, so the card and the CPU draw the same field and no
noise image crosses the bus.

Images are (H, W, 3) float tensors on the 0-255 scale in the dataset's
channel order.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

_LUMA = (0.299, 0.587, 0.114)
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based random fields
# ---------------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values below
    2^32 (each product stays below 2^63)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def uniform_field(seed: int, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1), a function of (seed, element index)
    alone: the same on every device."""
    n = math.prod(shape)
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = _mix32(x ^ (seed & _M32))
    x = _mix32(x ^ ((seed >> 32) & _M32) ^ 0x5BD1E995)
    return ((x >> 8).to(torch.float32) * (2.0 ** -24)).reshape(shape)


def normal_field(seed: int, shape, device) -> torch.Tensor:
    """float32 standard normals by Box-Muller over two uniform fields."""
    u1 = uniform_field(seed, shape, device)
    u2 = uniform_field(seed ^ 0x9E3779B97F4A7C15, shape, device)
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def _u(gen: torch.Generator, lo: float = 0.0, hi: float = 1.0) -> float:
    """A float32 uniform in [lo, hi) from the CPU generator."""
    u = torch.rand((), generator=gen)
    return float(u * (hi - lo) + lo)


# ---------------------------------------------------------------------------
# HSV round trip (float; H in degrees [0, 360), S in [0, 1], V in [0, 255])
# ---------------------------------------------------------------------------

def rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h * 60.0, 360.0), 0.0)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v


# Per sector i = floor(h / 60): which of (c, x, 0) each of r, g, b takes.
_R_SEL = (0, 1, 2, 2, 1, 0)
_G_SEL = (1, 0, 0, 1, 2, 2)
_B_SEL = (2, 2, 1, 0, 0, 1)


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    hp = torch.remainder(h, 360.0) / 60.0
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    i = torch.remainder(torch.floor(hp).to(torch.int64), 6)
    parts = torch.stack([c, x, torch.zeros_like(c)], dim=-1)

    def pick(sel):
        idx = torch.tensor(sel, device=h.device)[i]
        return torch.gather(parts, -1, idx[..., None])[..., 0]
    return torch.stack([pick(_R_SEL) + m, pick(_G_SEL) + m,
                        pick(_B_SEL) + m], dim=-1)


def draw_hsv_gain(gen, s_range, v_range):
    return _u(gen, *s_range), _u(gen, *v_range)


def hsv_gain(img, fs: float, fv: float):
    """S/V gains through a BGR-interpreted HSV round trip (the reference
    converts with COLOR_BGR2HSV whatever the channel order,
    ycb_dataset.py:112)."""
    h, s, v = rgb_to_hsv(torch.flip(img, [-1]))
    s = torch.clamp(s * fs, 0.0, 1.0)
    v = torch.clamp(v * fv, 0.0, 255.0)
    return torch.flip(hsv_to_rgb(h, s, v), [-1])


# ---------------------------------------------------------------------------
# ColorJitter (torchvision semantics)
# ---------------------------------------------------------------------------

def draw_color_jitter(gen, brightness=0.2, contrast=0.2, saturation=0.2,
                      hue=0.05) -> Dict:
    return {"perm": torch.randperm(4, generator=gen).tolist(),
            "fb": _u(gen, 1 - brightness, 1 + brightness),
            "fc": _u(gen, 1 - contrast, 1 + contrast),
            "fs": _u(gen, 1 - saturation, 1 + saturation),
            "fh": _u(gen, -hue, hue)}


def color_jitter(img, d: Dict):
    """Brightness, contrast, saturation and hue in the drawn order."""
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=img.device)
    x = img.float()
    for op in d["perm"]:
        if op == 0:
            x = x * d["fb"]
        elif op == 1:
            gray = torch.mean(torch.clamp(x, 0, 255) @ luma)
            x = (x - gray) * d["fc"] + gray
        elif op == 2:
            gray = (torch.clamp(x, 0, 255) @ luma)[..., None]
            x = (x - gray) * d["fs"] + gray
        else:
            h, s, v = rgb_to_hsv(torch.clamp(x, 0, 255))
            x = hsv_to_rgb(torch.remainder(h + d["fh"] * 360.0, 360.0), s, v)
    return torch.clamp(x, 0, 255)


# ---------------------------------------------------------------------------
# Blur / sharpen / noise
# ---------------------------------------------------------------------------

def conv2d_same(img, kern):
    """Depthwise 'same' correlation of an (H, W, 3) image with a (k, k)
    kernel, edge-replicated borders (no flip, as cv2.filter2D)."""
    k = kern.shape[0]
    pad = k // 2
    x = img.permute(2, 0, 1)[None]
    x = F.pad(x, (pad, k - 1 - pad, pad, k - 1 - pad), mode="replicate")
    w = kern.to(img.dtype)[None, None].expand(img.shape[-1], 1, k, k)
    return F.conv2d(x, w, groups=img.shape[-1])[0].permute(1, 2, 0)


def sharpen(img, center_u: float):
    """3x3 all -1 kernel with a 9..12 center, normalised
    (ycb_dataset.py:118-124)."""
    center = torch.tensor(center_u, dtype=torch.float32) * 3.0 + 9.0
    kern = torch.full((3, 3), -1.0)
    kern[1, 1] = center
    return conv2d_same(img, (kern / (center - 8.0)).to(img.device))


def motion_blur_kernel(angle_u: float, length_u: float, max_len: int = 15,
                       support: int = 31) -> torch.Tensor:
    """Weight 1 where a pixel centre lies within half a pixel of the
    segment from the support's centre toward (cos a, sin a) * length,
    normalised (linear_motion_blur, ycb_dataset.py:90-107)."""
    f32 = torch.float32
    ang = torch.floor(torch.tensor(angle_u, dtype=f32) * 360.0) \
        * math.pi / 180.0
    length = torch.floor(torch.tensor(length_u, dtype=f32) * max_len) + 1.0
    dx, dy = torch.cos(ang), torch.sin(ang)
    c = support // 2
    ys, xs = torch.meshgrid(torch.arange(support), torch.arange(support),
                            indexing="ij")
    px = xs.to(f32) - c
    py = ys.to(f32) - c
    t = torch.clamp(px * dx + py * dy, min=0.0, max=float(length))
    dist = torch.sqrt((px - t * dx) ** 2 + (py - t * dy) ** 2)
    kern = (dist <= 0.5).to(f32)
    return kern / torch.clamp(kern.sum(), min=1.0)


def motion_blur(img, angle_u: float, length_u: float):
    return conv2d_same(img, motion_blur_kernel(angle_u, length_u).to(
        img.device))


def gaussian_kernel(use5_u: float, sigma_u: float) -> torch.Tensor:
    """cv2.GaussianBlur's kernel at ksize 3 (80%) or 5 and sigma U(0, 1)
    (at least 1e-3)."""
    use5 = use5_u <= 0.2
    sigma = torch.clamp(torch.tensor(sigma_u, dtype=torch.float32),
                        min=1e-3)
    xs = torch.arange(5, dtype=torch.float32) - 2.0
    g = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    g = torch.where((torch.abs(xs) <= 1) | use5, g, 0.0)
    g = g / g.sum()
    return g[:, None] * g[None, :]


def gaussian_blur(img, use5_u: float, sigma_u: float):
    return conv2d_same(img, gaussian_kernel(use5_u, sigma_u).to(img.device))


def draw_noise_ycb(gen) -> Dict:
    """The YCB stack's values: the HSV gains, each maybe's gate uniform
    and parameters, both noise sigmas and the two noise fields' seeds."""
    fs, fv = draw_hsv_gain(gen, (1.25, 1.45), (1.15, 1.35))
    return {"fs": fs, "fv": fv,
            "sharpen_u": _u(gen), "center_u": _u(gen),
            "motion_u": _u(gen), "angle_u": _u(gen), "length_u": _u(gen),
            "gauss_u": _u(gen), "use5_u": _u(gen), "sigma_u": _u(gen),
            "sigma_gate_u": _u(gen),
            "sigma15": int(torch.randint(0, 15, (1,), generator=gen)),
            "sigma25": int(torch.randint(0, 25, (1,), generator=gen)),
            "noise_seed": draw_seed(gen),
            "extra_u": _u(gen), "extra_seed": draw_seed(gen)}


def rgb_add_noise_ycb(img, d: Dict):
    """YCB synthetic-image noise stack (ycb_dataset.py:109-145): HSV gain,
    maybe sharpen / motion blur / gaussian blur (p 0.2 each), gaussian
    noise, maybe extra sigma-7 noise (p 0.2).  The host stack passes
    uint8 between ops, so each op's result is clamped (not rounded)."""
    img = hsv_gain(img, d["fs"], d["fv"])
    if d["sharpen_u"] > 0.8:
        img = sharpen(img, d["center_u"])
    img = torch.clamp(img, 0, 255)
    if d["motion_u"] > 0.8:
        img = motion_blur(img, d["angle_u"], d["length_u"])
    img = torch.clamp(img, 0, 255)
    if d["gauss_u"] > 0.8:
        img = gaussian_blur(img, d["use5_u"], d["sigma_u"])
    img = torch.clamp(img, 0, 255)
    sigma = float(d["sigma15"] if d["sigma_gate_u"] > 0.2 else d["sigma25"])
    noise = normal_field(d["noise_seed"], tuple(img.shape), img.device)
    img = torch.clamp(img + noise * sigma, 0, 255)
    if d["extra_u"] > 0.8:
        img = img + normal_field(d["extra_seed"], tuple(img.shape),
                                 img.device) * 7.0
    return torch.clamp(img, 0, 255)


def draw_noise_lm(gen) -> Dict:
    fs, fv = draw_hsv_gain(gen, (0.75, 1.25), (0.85, 1.15))
    return {"fs": fs, "fv": fv,
            "motion_u": _u(gen), "angle_u": _u(gen), "length_u": _u(gen),
            "gauss_u": _u(gen), "use5_u": _u(gen), "sigma_u": _u(gen)}


def rgb_add_noise_lm(img, d: Dict):
    """LineMOD variant (linemod_dataset.py:129-150): symmetric HSV gains,
    maybe motion / gaussian blur only."""
    img = hsv_gain(img, d["fs"], d["fv"])
    if d["motion_u"] > 0.8:
        img = motion_blur(img, d["angle_u"], d["length_u"])
    if d["gauss_u"] > 0.8:
        img = gaussian_blur(img, d["use5_u"], d["sigma_u"])
    return torch.clamp(img, 0, 255)


def add_real_back(rgb, labels, depth, back_rgb, back_depth, back_label):
    """Paste a synthetic render over a real background frame
    (add_real_back, ycb_dataset.py:159-177): the render's background
    pixels take the real frame's background, missing depth likewise."""
    bk_free = (back_label <= 0).float()
    fg = (labels > 0).float()[..., None]
    rgb_out = rgb * fg + back_rgb[..., :3].float() * bk_free[..., None] * (
        1 - fg)
    dm = (depth > 1e-6).float()
    depth_out = depth * dm + back_depth * bk_free * (1 - dm)
    return rgb_out, depth_out
