"""Frame preprocessing on the device: depth completion and normals.

Port of the JAX package's ``ops/preprocess.py`` on batched (B, H, W)
float32 maps, with no loop over frames:

* ``fill_in_multiscale`` / ``fill_missing``: ip_basic depth completion
  (reference depth_map_utils_ycb.py:290-445): inverted-depth multi-bin
  cross dilation, a morphological close, a 5x5 median, top-mask hole
  filling, then a median and a bilateral smoothing pass.
* ``normals_from_depth_map``: box-blurred unprojection, central
  differences (wrapping at the image edge, as ``jnp.roll`` does), the
  cross product, camera-facing orientation, invalid pixels and depth jumps
  zeroed.

The JAX package computes both with XLA ops; there is no Pallas kernel on
this path.  Here they are plain PyTorch: morphology is ``max_pool2d``
(which pads with -inf, the ``reduce_window`` init), erosion is
``-max_pool2d(-x)``, the median takes the 25 taps of an edge-replicated
5x5 window with ``unfold`` and ``median`` (equal to the JAX selection
network, which is exact), the bilateral filter weights the same 25 taps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Validity threshold on (inverted) depths: 0.01 everywhere, as in the JAX
# package and the reference's fill_in_multiscale.
_VALID_EPS = 0.01


def _pool_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Max over a (kh, kw) window centred on each pixel of (B, H, W) maps,
    out-of-image taps ignored."""
    return F.max_pool2d(x[:, None], (kh, kw), stride=1,
                        padding=(kh // 2, kw // 2))[:, 0]


def _dilate_full(x: torch.Tensor, size: int) -> torch.Tensor:
    """Grayscale dilation with a size x size square (cv2.dilate with
    np.ones)."""
    return _pool_max(x, size, size)


def _erode_full(x: torch.Tensor, size: int) -> torch.Tensor:
    return -_pool_max(-x, size, size)


def _dilate_cross(x: torch.Tensor, size: int) -> torch.Tensor:
    """Dilation with a plus-shaped kernel: the max of the horizontal and
    vertical 1-D max filters."""
    return torch.maximum(_pool_max(x, 1, size), _pool_max(x, size, 1))


def _taps5(x: torch.Tensor) -> torch.Tensor:
    """The 25 taps of each pixel's 5x5 window with edge-replicated borders:
    (B, H, W) -> (B, 25, H, W), taps in row-major window order."""
    b, h, w = x.shape
    xp = F.pad(x[:, None], (2, 2, 2, 2), mode="replicate")
    return F.unfold(xp, 5).reshape(b, 25, h, w)


def _median5(x: torch.Tensor) -> torch.Tensor:
    """5x5 median with cv2.medianBlur's BORDER_REPLICATE semantics."""
    return _taps5(x).median(dim=1).values


def _bilateral5(x: torch.Tensor, sigma_color: float,
                sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter(d=5, sigmaColor, sigmaSpace): a circular
    neighbourhood of radius 2 with replicated borders, weights
    exp(-dv^2/2sc^2) * exp(-dist^2/2ss^2)."""
    taps = _taps5(x)
    offs = torch.arange(5, dtype=torch.float32, device=x.device) - 2
    d2 = (offs[:, None] * offs[:, None] + offs[None, :] * offs[None, :]
          ).reshape(25, 1, 1)
    sw = torch.exp(-0.5 * d2 / (sigma_space * sigma_space))
    sw = torch.where(d2 <= 2.0 * 2.0 + 1e-6, sw, 0.0)   # cv2's circle
    dv = taps - x[:, None]
    cw = torch.exp(-0.5 * (dv * dv) / (sigma_color * sigma_color))
    wsum = (sw * cw).sum(dim=1)
    return (sw * cw * taps).sum(dim=1) / torch.clamp(wsum, min=1e-20)


def _first_valid_row(valid: torch.Tensor) -> torch.Tensor:
    """Per column of (B, H, W) masks, the first True row, or 0 for a column
    with none (``jnp.argmax`` of an all-False column)."""
    h = valid.shape[-2]
    rows = torch.arange(h, device=valid.device)[:, None]
    first = torch.where(valid, rows, h).amin(dim=-2)
    return torch.where(first == h, 0, first)


def _top_valid_mask(depth: torch.Tensor) -> torch.Tensor:
    """True at and below each column's first valid row (the whole column
    when it has no valid pixel)."""
    top = _first_valid_row(depth > _VALID_EPS)
    rows = torch.arange(depth.shape[-2], device=depth.device)[:, None]
    return rows >= top[:, None, :]


def fill_in_multiscale(depth: torch.Tensor, max_depth: float = 3.0,
                       near_bin: float = 1.0, med_bin: float = 2.0,
                       extrapolate: bool = False) -> torch.Tensor:
    """ip_basic multi-scale depth completion (bilateral blur, the YCB
    default) of (B, H, W) depth maps in metres."""
    d = depth.float()
    valid = d > _VALID_EPS
    near = valid & (d <= near_bin)
    med = (d > near_bin) & (d <= med_bin)
    far = d > med_bin

    inv = torch.where(valid, max_depth - d, d)

    dil_far = _dilate_cross(inv * far, 3)
    dil_med = _dilate_cross(inv * med, 5)
    dil_near = _dilate_cross(inv * near, 7)

    out = inv
    for layer in (dil_far, dil_med, dil_near):
        out = torch.where(layer > _VALID_EPS, layer, out)

    out = _erode_full(_dilate_full(out, 5), 5)        # MORPH_CLOSE

    out = torch.where(out > _VALID_EPS, _median5(out), out)

    empty = (~(out > _VALID_EPS)) & _top_valid_mask(out)
    out = torch.where(empty, _dilate_full(out, 9), out)

    if extrapolate:
        vrows = _first_valid_row(out > _VALID_EPS)
        top_vals = torch.gather(out, -2, vrows[:, None, :])
        rows = torch.arange(out.shape[-2], device=out.device)[:, None]
        out = torch.where(rows < vrows[:, None, :], top_vals, out)
        top_mask = torch.ones_like(out, dtype=torch.bool)
    else:
        top_mask = _top_valid_mask(out)

    for _ in range(6):
        empty = (out < _VALID_EPS) & top_mask
        out = torch.where(empty, _dilate_full(out, 5), out)

    m = (out > _VALID_EPS) & top_mask
    out = torch.where(m, _median5(out), out)
    out = torch.where(m, _bilateral5(out, 0.5, 2.0), out)

    return torch.where(out > _VALID_EPS, max_depth - out, out)


def fill_missing(depth: torch.Tensor, cam_scale: float = 1.0,
                 scale_to_m: float = 1.0,
                 max_depth: float = 3.0) -> torch.Tensor:
    """``fill_missing`` semantics (basic_utils.py:436-456), multi-scale
    type: (B, H, W) depths in ``cam_scale`` units per metre, filled in
    metres and scaled back."""
    d = depth / cam_scale * scale_to_m
    return fill_in_multiscale(d, max_depth=max_depth) / scale_to_m \
        * cam_scale


def _box_blur(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over each pixel's (2r+1)^2 window of (B, H, W) maps with
    edge-replicated borders: the window sum (columns, then rows) divided
    by its size."""
    if r <= 0:
        return x
    size = 2 * r + 1
    xp = F.pad(x[:, None], (r, r, r, r), mode="replicate")
    y = F.avg_pool2d(xp, (size, 1), stride=1, divisor_override=1)
    y = F.avg_pool2d(y, (1, size), stride=1, divisor_override=1)
    return y[:, 0] / (size * size)


def _central_diff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Central difference along ``dim``, wrapping at the edge."""
    fwd = torch.roll(a, -1, dims=dim) - a
    bwd = a - torch.roll(a, 1, dims=dim)
    return (fwd + bwd) * 0.5


def normals_from_depth_map(depth: torch.Tensor, k: torch.Tensor,
                           cam_scale: float = 1.0, smooth: int = 2,
                           depth_jump: float = 0.05) -> torch.Tensor:
    """Unit camera-facing normals (B, H, W, 3) of (B, H, W) depth maps with
    (B, 3, 3) intrinsics; zero where the depth is invalid or jumps by more
    than ``depth_jump`` metres to a neighbour."""
    h, w = depth.shape[-2:]
    z = depth.float() / cam_scale
    k = k.float()
    valid = z > 1e-6
    cols = torch.arange(w, dtype=torch.float32, device=z.device)
    rows = torch.arange(h, dtype=torch.float32, device=z.device)[:, None]

    if smooth:
        zs = _box_blur(torch.where(valid, z, 0.0), smooth)
        ws = _box_blur(valid.float(), smooth)
        z_sm = torch.where(ws > 1e-6, zs / torch.clamp(ws, min=1e-6), z)
    else:
        z_sm = z
    fx, fy = k[:, 0, 0, None, None], k[:, 1, 1, None, None]
    cx, cy = k[:, 0, 2, None, None], k[:, 1, 2, None, None]
    p = torch.stack([(cols - cx) * z_sm / fx, (rows - cy) * z_sm / fy, z_sm],
                    dim=-1)

    du = _central_diff(p, -2)
    dv = _central_diff(p, -3)
    jump_u = _central_diff(z, -1).abs() > depth_jump
    jump_v = _central_diff(z, -2).abs() > depth_jump
    n = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    n = torch.where(norm > 1e-12, n / torch.clamp(norm, min=1e-12), 0.0)
    flip = (n * p).sum(dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    bad = (~valid) | jump_u | jump_v
    return torch.where(bad[..., None], 0.0, n)
