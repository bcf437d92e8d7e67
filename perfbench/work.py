"""The yardstick's work counts: the model's FLOPs, each kernel's least
time on its inputs, and the card's published peaks.

FLOPs are those of the configuration's literal published graph
(ethnhe/PVN3D ``pvn3d/lib/pvn3d.py``, ``pspnet.py``, ``extractors.py``):
the dense CNN tail at every pixel, the fusion's global feature broadcast
to every point, each head's first layer on the concatenated 1792
channels.  They count every convolution and dense layer (2 per
multiply-add) and nothing else, so a program that skips work (the sparse
tail, the split heads) is still held to the same count.  Everything is
reckoned from the configuration's sizes, never read from the program.

Kernel work is that of the function on the inputs of the call: each input
byte read once and each output byte written once, and, where the work
depends on the data, what these inputs need (K2: the first-``ns`` scans;
K4: the valid pairs only).  The counts are ``chip_smoke.py``'s.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense: the tensor cores in bf16, the
# float32 pipes outside them, HBM3.  Rated at a 700 W power limit.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
D2_FLOPS = 8          # 3 sub + 3 mul + 2 add per direct-form d^2


def _conv(out_hw: int, c_in: int, c_out: int, k: int = 1) -> float:
    return 2.0 * out_hw * c_in * c_out * k * k


def image_branch_flops(model: Dict) -> float:
    """Dilated ResNet (output stride 8) + PSP + three 2x upsample stages
    + the two 1x1 heads, at every pixel."""
    cnn = model["cnn"]
    h, w = model["image_height"], model["image_width"]
    f = _conv((h // 2) * (w // 2), 3, 64, 7)                    # stem
    hw = (h // 4) * (w // 4)                                     # max pool
    c = 64
    for s, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 1),
                                          (512, 1))):
        for b in range(cnn["backbone_layers"][s]):
            if b == 0 and stride == 2:
                hw //= 4
            f += _conv(hw, c, planes, 3) + _conv(hw, planes, planes, 3)
            if b == 0 and (stride != 1 or c != planes):
                f += _conv(hw, c, planes, 1)                     # downsample
            c = planes
    feats = cnn["psp_features"]
    for s in cnn["psp_sizes"]:
        f += _conv(s * s, feats, feats, 1)
    f += _conv(hw, feats * (len(cnn["psp_sizes"]) + 1), cnn["psp_out"], 1)
    c = cnn["psp_out"]
    for ch in cnn["up_channels"]:
        hw *= 4
        f += _conv(hw, c, ch, 3)
        c = ch
    return f + _conv(hw, c, cnn["embedding_dim"], 1) + _conv(
        hw, c, model["n_classes"], 1)


def point_branch_flops(model: Dict) -> float:
    """PointNet++ MSG: each SA scale's MLP on npoint x nsample grouped
    rows (xyz + features in), each FP MLP on its unknown rows."""
    pn = model["pointnet2"]
    n = model["n_sample_points"]
    f = 0.0
    c_in = pn["input_channels"]
    skips, rows = [c_in], [n]
    for lv in pn["sa_levels"]:
        for ns, widths in zip(lv["nsamples"], lv["mlps"]):
            c = c_in + 3
            for wd in widths:
                f += _conv(lv["npoint"] * ns, c, wd)
                c = wd
        c_in = sum(wd[-1] for wd in lv["mlps"])
        skips.append(c_in)
        rows.append(lv["npoint"])
    levels = len(pn["sa_levels"])
    for i, widths in enumerate(pn["fp_mlps"]):
        known = pn["fp_mlps"][i + 1][-1] if i < levels - 1 else skips[i + 1]
        c = skips[i] + known
        for wd in widths:
            f += _conv(rows[i], c, wd)
            c = wd
    return f


def fusion_heads_flops(model: Dict) -> float:
    """DenseFusion's four 1x1 convs and the three heads on every point."""
    n = model["n_sample_points"]
    e_rgb = model["cnn"]["embedding_dim"]
    e_cld = model["pointnet2"]["fp_mlps"][0][-1]
    f = (_conv(n, e_rgb, 256) + _conv(n, e_cld, 256)
         + _conv(n, e_rgb + e_cld, 512) + _conv(n, 512, 1024))
    fused = e_rgb + e_cld + 2 * 256 + 1024
    for widths, out in ((model["seg_head"], model["n_classes"]),
                        (model["kp_head"], model["n_keypoints"] * 3),
                        (model["ctr_head"], 3)):
        c = fused
        for wd in list(widths) + [out]:
            f += _conv(n, c, wd)
            c = wd
    return f


def forward_flops(model: Dict) -> float:
    """One frame's forward FLOPs of the literal published graph."""
    return (image_branch_flops(model) + point_branch_flops(model)
            + fusion_heads_flops(model))


def least_seconds(n_bytes: float, flops: float) -> Tuple[float, str]:
    """The least time of a call on the card and what bounds it."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_F32
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Each kernel's (bytes, flops) from the arguments and result of one call
# of its op entry point; shapes in the docstrings.

def fps_work(xyz, npoint: int, out) -> Tuple[float, float]:
    """K1: (B, N, 3) -> (B, npoint); npoint-1 steps of a d^2 and a
    compare per point."""
    b, n, _ = xyz.shape
    return (b * (n * 12 + npoint * 4),
            b * (npoint - 1) * n * (D2_FLOPS + 1))


def ball_query_work(radii, nsamples, xyz, new_xyz, outs) -> Tuple[float,
                                                                  float]:
    """K2: the pairs each centroid's scan must test on these inputs: up to
    the index of the last slot of the scale that fills last (all N when
    one never fills), a d^2 and a compare per scale each."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    tests = None
    for o, ns in zip(outs, nsamples):
        hits = (o != o[..., :1]).sum(-1) + 1
        stop = (o[..., -1].double() + 1).where(hits >= ns,
                                                o.new_tensor(float(n),
                                                             dtype=o.dtype)
                                                .double())
        tests = stop if tests is None else tests.maximum(stop)
    n_bytes = b * (n * 12 + m * 12 + m * sum(nsamples) * 4)
    return n_bytes, float(tests.sum()) * (D2_FLOPS + len(radii))


def interp_work(unknown, known, features) -> Tuple[float, float]:
    """K3 forward: (B, n, 3), (B, m, 3), (B, m, C) -> out (B, n, C), dist
    and idx (B, n, 3); every (unknown, known) pair's d^2 and compare, a
    5-flop blend per output channel."""
    b, nu, _ = unknown.shape
    nk = known.shape[1]
    c = features.shape[-1]
    return (b * (nu * 12 + nk * 12 + nk * c * 4 + nu * c * 4 + nu * 24),
            b * (nu * nk * (D2_FLOPS + 1) + nu * c * 5))


def interp_backward_work(g_out, m: int) -> Tuple[float, float]:
    """K3 backward: g_out (B, n, C), idx and dist (B, n, 3) -> (B, m, C);
    bytes only."""
    b, n, c = g_out.shape
    return b * (n * c + m * c) * 4 + b * n * 24, 0.0


def winner_work(points, mask) -> Tuple[float, float]:
    """K4: (H, K, 3) + (H, K) -> win, labels, counts; the valid pairs'
    tests, v^2 + v per hypothesis."""
    h, k, _ = points.shape
    v = mask.bool().sum(1).double()
    return h * k * 14 + h * 8, float((v * v + v).sum()) * (D2_FLOPS + 1)
