"""RGB / scene augmentations on the host, in numpy and scipy.

Port of the JAX package's ``data/augment.py`` (the reference's training
augmentation: torchvision-style ColorJitter(0.2, 0.2, 0.2, 0.05) on every
training image, ycb_dataset.py:29,193; the synthetic-image noise stack
``rgb_add_noise``, ycb_dataset.py:109-145, and its LineMOD variant,
linemod_dataset.py:129-150; ``add_real_back``, ycb_dataset.py:159-177).
The JAX module computes with cv2; this one has no cv2 and keeps:

- the same ``np.random.RandomState`` draws in the same order, so every
  later frame of a stream is the same frame;
- cv2's uint8 HSV conversions (H in 0-179): the forward one exactly, in
  cv2's integer arithmetic (12-bit fixed-point division tables), the
  inverse one within one level, in float32 in cv2's sector order;
- ``cv2.filter2D`` as a correlation with BORDER_REFLECT_101 borders
  (scipy's ``mode="mirror"``), rounded half to even to uint8;
- ``cv2.GaussianBlur`` in its 8-bit fixed point, exactly;
- the motion-blur kernel rasterised as ``cv2.line`` draws a 1-pixel,
  8-connected line (OpenCV's clipLine and LineIterator).

cv2 filters kernels of 130 taps or more by DFT, so the motion blur can
differ from this module's float64 correlation by one grey level on a few
pixels; ``tests/test_torch_data.py`` holds the gap.

All functions take and return uint8 (or float) HWC images and an explicit
``np.random.RandomState``.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

_HSV_SHIFT = 12


def _rand_range(rng, lo, hi):
    return rng.rand() * (hi - lo) + lo


def _to_u8(x: np.ndarray) -> np.ndarray:
    """cv2's saturate_cast<uchar> of a float: round half to even, clip."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _div_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / i)])
    hdiv = np.concatenate(
        [[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))])
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV180 = _div_tables()


def rgb_to_hsv_u8(img: np.ndarray, bgr: bool = False) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) (``COLOR_BGR2HSV`` with ``bgr``)
    of a uint8 (H, W, 3) image: H in 0-179, S and V in 0-255."""
    x = img.astype(np.int64)
    r, g, b = (x[..., 2], x[..., 1], x[..., 0]) if bgr else (
        x[..., 0], x[..., 1], x[..., 2])
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# cv2's HSV -> RGB sector table: (b, g, r) rows of [v, v(1-s), v(1-sh),
# v(1-s(1-h))].
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray, bgr: bool = False) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) (``COLOR_HSV2BGR`` with ``bgr``)
    of a uint8 (H, W, 3) image with H in 0-179.

    float32 on the 0-1 scale in cv2's sector order, times 255, truncated
    (one product a fused multiply-add, emulated in float64), as cv2 5.0's
    vectorised path: equal to it on all but 488 of the 180 x 256 x 256
    HSV triples, and those one level apart.  cv2 rounds the scalar tail
    of a row past a multiple of its vector width instead (none in a
    640-pixel row), one level apart on some pixels there."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    out_of_range = (sector < 0) | (sector >= 6)
    sector = np.where(out_of_range, 0, sector)
    h = np.where(out_of_range, f32(0.0), h)
    one = f32(1.0)
    fma = (1.0 - s.astype(np.float64) * h.astype(np.float64)).astype(f32)
    tab = np.stack([v, v * (one - s), v * fma, v * ((one - s) + s * h)],
                   axis=-1)
    idx = _SECTORS[sector]                                # (..., 3) b, g, r
    bgr_vals = np.take_along_axis(tab, idx, axis=-1)
    bgr_vals = np.where((s == 0)[..., None], v[..., None], bgr_vals)
    out = np.clip(np.floor(bgr_vals * f32(255.0)), 0, 255).astype(np.uint8)
    return out if bgr else out[..., ::-1]


def color_jitter(rng: np.random.RandomState, img: np.ndarray,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.05) -> np.ndarray:
    """torchvision ColorJitter semantics: random order of the four ops,
    factors uniform in [max(0, 1-x), 1+x] (hue in [-hue, hue])."""
    # Luma weights of cv2.COLOR_RGB2GRAY, on the clipped float image.
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    img = img.astype(np.float32)
    ops = list(range(4))
    rng.shuffle(ops)
    for op in ops:
        if op == 0 and brightness:
            img = img * _rand_range(rng, 1 - brightness, 1 + brightness)
        elif op == 1 and contrast:
            f = _rand_range(rng, 1 - contrast, 1 + contrast)
            gray = np.clip(img, 0, 255).mean(axis=(0, 1)) @ luma
            img = (img - gray) * f + gray
        elif op == 2 and saturation:
            f = _rand_range(rng, 1 - saturation, 1 + saturation)
            gray = np.clip(img, 0, 255) @ luma
            img = (img - gray[..., None]) * f + gray[..., None]
        elif op == 3 and hue:
            h = _rand_range(rng, -hue, hue)
            hsv = rgb_to_hsv_u8(np.clip(img, 0, 255).astype(np.uint8)
                                ).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(h * 180)) % 180
            img = hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of a uint8 (H, W, C) image: a
    correlation anchored at the kernel's centre (size // 2) with
    BORDER_REFLECT_101 borders, rounded to uint8."""
    k = np.asarray(kernel, np.float64)
    x = img.astype(np.float64)
    out = np.stack([ndimage.correlate(x[..., c], k, mode="mirror")
                    for c in range(x.shape[-1])], axis=-1)
    return _to_u8(out)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: the segment clipped to the w x h image, or None
    when it misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if (c1 | c2) != 0:
        return None
    return x1, y1, x2, y2


def draw_line(img: np.ndarray, p1, p2, value: float = 1.0) -> None:
    """cv2.line(img, p1, p2, value) with thickness 1 and 8-connectivity,
    in place: OpenCV's LineIterator, left to right, after clipLine."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, int(p1[0]), int(p1[1]), int(p2[0]),
                         int(p2[1]))
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    if x2 < x1:                            # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0                     # also move along the minor axis
        err += minus_delta + (plus_delta if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def motion_blur_kernel(angle_deg: float, length: int):
    """The reference's line kernel (linear_motion_blur,
    ycb_dataset.py:90-107), or None for an empty support."""
    rad = np.deg2rad(angle_deg)
    dx, dy = np.cos(rad), np.sin(rad)
    a = int(max(abs(dx), abs(dy)) * length * 2)
    if a <= 0:
        return None
    kern = np.zeros((a, a), np.float32)
    cx = cy = a // 2
    ex, ey = int(dx * length + cx), int(dy * length + cy)
    draw_line(kern, (cx, cy), (ex, ey), 1.0)
    s = kern.sum()
    if s == 0:
        kern[cy, cx] = 1.0
    else:
        kern /= s
    return kern


def linear_motion_blur(img: np.ndarray, angle_deg: float,
                       length: int) -> np.ndarray:
    kern = motion_blur_kernel(angle_deg, length)
    return img if kern is None else filter2d(img, kern)


def gaussian_kernel_fixed(ksize: int, sigma: float) -> np.ndarray:
    """cv2's bit-exact 8-bit Gaussian kernel for sigma > 0: the taps of
    ``getGaussianKernel`` in 1/256 units, rounded with the error carried
    from the outer taps inward, the centre taking what is left of 256."""
    scale2x = -0.125 / (sigma * sigma)
    half = (ksize - 1) // 2
    vals = [math.exp((x * x) * scale2x)
            for x in range(1 - ksize, 1 - ksize + 2 * half, 2)]
    total = sum(vals) * 2.0 + 1.0
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i, v in enumerate(vals):
        adj = v / total * 256.0 + err
        out[i] = out[ksize - 1 - i] = int(np.rint(adj))
        err = adj - out[i]
    out[half] = 256 - 2 * int(out[:half].sum())
    return out


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) of a uint8 (H, W, C)
    image, in cv2's 8-bit fixed point: rows then columns with the integer
    kernel (BORDER_REFLECT_101), rounded half up from 16 fraction bits."""
    k = gaussian_kernel_fixed(ksize, sigma)
    x = img.astype(np.int64)
    x = ndimage.correlate1d(x, k, axis=1, mode="mirror")
    x = ndimage.correlate1d(x, k, axis=0, mode="mirror")
    return np.clip((x + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _standard_normal_f32(rng: np.random.RandomState, shape) -> np.ndarray:
    """N(0,1) samples in float32 via a Generator seeded from ``rng``
    (the JAX package's choice: float32 draws at image size)."""
    gen = np.random.Generator(np.random.PCG64(rng.randint(1 << 31)))
    return gen.standard_normal(shape, dtype=np.float32)


def gaussian_noise(rng, img: np.ndarray, sigma: float) -> np.ndarray:
    out = img.astype(np.float32) + _standard_normal_f32(rng, img.shape) * sigma
    return np.clip(out, 0, 255).astype(np.uint8)


def _hsv_gain(rng, img, s_range, v_range):
    # The reference converts with COLOR_BGR2HSV whatever the array's
    # channel order (ycb_dataset.py:112); kept.
    hsv = rgb_to_hsv_u8(img, bgr=True).astype(np.uint16)
    hsv[..., 1] = np.clip(hsv[..., 1] * _rand_range(rng, *s_range), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * _rand_range(rng, *v_range), 0, 255)
    return hsv_to_rgb_u8(hsv.astype(np.uint8), bgr=True)


def rgb_add_noise_ycb(rng: np.random.RandomState,
                      img: np.ndarray) -> np.ndarray:
    """YCB synthetic-image noise stack (ycb_dataset.py:109-145)."""
    img = _hsv_gain(rng, img, (1.25, 1.45), (1.15, 1.35))

    if rng.rand() > 0.8:                                  # sharpen
        kernel = -np.ones((3, 3), np.float32)
        kernel[1, 1] = rng.rand() * 3 + 9
        kernel /= kernel.sum()
        img = filter2d(img, kernel)

    if rng.rand() > 0.8:                                  # motion blur
        img = linear_motion_blur(img, int(rng.rand() * 360),
                                 int(rng.rand() * 15) + 1)

    if rng.rand() > 0.8:                                  # gaussian blur
        ksz = 3 if rng.rand() > 0.2 else 5
        img = gaussian_blur(img, ksz, rng.rand())

    sigma = rng.randint(15) if rng.rand() > 0.2 else rng.randint(25)
    img = gaussian_noise(rng, img, sigma)

    if rng.rand() > 0.8:
        # Drawn from the worker's rng, as in the JAX package (the
        # reference uses the global np.random, ycb_dataset.py:143).
        img = img + _standard_normal_f32(rng, img.shape) * 7.0
    return np.clip(img, 0, 255).astype(np.uint8)


def rgb_add_noise_lm(rng: np.random.RandomState,
                     img: np.ndarray) -> np.ndarray:
    """LineMOD variant (linemod_dataset.py:129-150): symmetric HSV gains,
    motion / gaussian blur only."""
    img = _hsv_gain(rng, img, (0.75, 1.25), (0.85, 1.15))
    if rng.rand() > 0.8:
        img = linear_motion_blur(img, int(rng.rand() * 360),
                                 int(rng.rand() * 15) + 1)
    if rng.rand() > 0.8:
        ksz = 3 if rng.rand() > 0.2 else 5
        img = gaussian_blur(img, ksz, rng.rand())
    return np.clip(img, 0, 255).astype(np.uint8)


def add_real_back(rgb: np.ndarray, labels: np.ndarray, depth: np.ndarray,
                  depth_mask: np.ndarray, back_rgb: np.ndarray,
                  back_depth: np.ndarray,
                  back_label: np.ndarray) -> tuple:
    """Paste a synthetic render onto a real background frame
    (add_real_back, ycb_dataset.py:159-177): background pixels (label <=
    0) of the render take the real image's background pixels; missing
    depth takes the real background depth."""
    bk_free = (back_label <= 0).astype(rgb.dtype)
    back = back_rgb[..., :3] * bk_free[..., None]
    dpt_back = back_depth.astype(np.float32) * bk_free.astype(np.float32)

    fg = (labels > 0).astype(rgb.dtype)[..., None]
    rgb = rgb * fg + back * (1 - fg)
    dm = (depth_mask > 0).astype(depth.dtype)
    depth = depth * dm + dpt_back * (1 - dm)
    return rgb, depth
