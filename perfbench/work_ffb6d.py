"""FFB6D's work counts: the literal graph's FLOPs a frame, and the k-NN
searches' least time on their inputs.

FLOPs are those of ethnhe/FFB6D's published graph (``ffb6d/models/
ffb6d.py``, ``models/RandLA/RandLANet.py``, ``pspnet.py``): the dense
image tail at every pixel, each fusion conv on its literal concatenation
at every pixel or point, every RandLA conv at every point and neighbour.
They count every convolution and dense layer (2 per multiply-add) and
nothing else, so a program that skips work (the sparse tail, the split
fusion product) is held to the same count.  Everything is reckoned from
the configuration's sizes, never read from the program.
"""
from __future__ import annotations

from typing import Dict, Tuple

from perfbench.work import D2_FLOPS, _conv


def _levels(model: Dict):
    sizes = [model["n_sample_points"]]
    for r in model["randla"]["sub_sampling_ratio"]:
        sizes.append(sizes[-1] // r)
    return sizes


def image_flops(model: Dict) -> float:
    """ResNet34 at output stride 8, PSP, ``up_1``, ``up_2``, ``final``,
    ``up_3`` and ``final`` again, at every pixel."""
    cnn = model["cnn"]
    h, w = model["image_height"], model["image_width"]
    f = _conv((h // 2) * (w // 2), 3, 64, 7)
    hw = (h // 4) * (w // 4)
    c = 64
    for s, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 1),
                                          (512, 1))):
        for b in range(cnn["backbone_layers"][s]):
            if b == 0 and stride == 2:
                hw //= 4
            f += _conv(hw, c, planes, 3) + _conv(hw, planes, planes, 3)
            if b == 0 and (stride != 1 or c != planes):
                f += _conv(hw, c, planes, 1)
            c = planes
    feats = cnn["psp_features"]
    for s in cnn["psp_sizes"]:
        f += _conv(s * s, feats, feats, 1)
    f += _conv(hw, feats * (len(cnn["psp_sizes"]) + 1), cnn["psp_out"], 1)
    c = cnn["psp_out"]
    emb = cnn["embedding_dim"]
    for k, ch in enumerate(cnn["up_channels"]):
        hw *= 4
        f += _conv(hw, c, ch, 3)
        c = ch
        if k == 1:                       # final after up_2's fusion
            f += _conv(hw, c, emb, 1)
            c = emb
    return f + _conv(hw, c, emb, 1)      # final after up_3


def point_flops(model: Dict) -> float:
    """fc0, the four dilated residual blocks (their convs at every point
    or every (point, neighbour) pair), the four decoder convs."""
    rl = model["randla"]
    k = rl["k_n"]
    sizes = _levels(model)
    f = _conv(sizes[0], rl["in_channels"], rl["fc0_width"])
    d_in = rl["fc0_width"]
    for n, d in zip(sizes, rl["d_out"]):
        f += _conv(n, d_in, d // 2)                          # mlp1
        f += _conv(n * k, 10, d // 2)                        # lfa.mlp1
        f += _conv(n * k, d, d) + _conv(n, d, d // 2)        # att 1
        f += _conv(n * k, d // 2, d // 2)                    # lfa.mlp2
        f += _conv(n * k, d, d) + _conv(n, d, d)             # att 2
        f += _conv(n, d, 2 * d) + _conv(n, d_in, 2 * d)      # mlp2, shortcut
        d_in = 2 * d
    skips = [2 * rl["d_out"][0]] + [2 * d for d in rl["d_out"]]
    prev = 2 * rl["d_out"][-1]
    n_dec = len(rl["decoder_widths"])
    for j, wd in enumerate(rl["decoder_widths"]):
        rows = sizes[n_dec - 1 - j]
        f += _conv(rows, skips[-j - 2] + prev, wd)
        prev = wd
    return f


def fusion_flops(model: Dict) -> float:
    """Each of the seven stages' four convs: ``p2r_pre`` and the r2p pair
    on the stage's points, ``p2r_fuse`` on every pixel of its map."""
    cnn, rl = model["cnn"], model["randla"]
    h, w = model["image_height"], model["image_width"]
    sizes = _levels(model)
    n_ds = len(model["ds_strides"])
    stages = []
    rgb_ds = (64, 128, cnn["psp_features"], cnn["psp_out"])
    for i, s in enumerate(model["ds_strides"]):
        stages.append((s, sizes[i + 1], rgb_ds[i], 2 * rl["d_out"][i]))
    rgb_up = tuple(cnn["up_channels"][:2]) + (cnn["embedding_dim"],)
    for j, s in enumerate(model["up_strides"]):
        stages.append((s, sizes[n_ds - 1 - j], rgb_up[j],
                       rl["decoder_widths"][j]))
    f = 0.0
    for s, m, ci, cp in stages:
        hw = (h // s) * (w // s)
        f += (_conv(m, cp, ci) + _conv(hw, 2 * ci, ci)
              + _conv(m, ci, cp) + _conv(m, 2 * cp, cp))
    return f


def heads_flops(model: Dict) -> float:
    n = model["n_sample_points"]
    c0 = model["cnn"]["embedding_dim"] + model["randla"]["decoder_widths"][-1]
    f = 0.0
    for widths, out in ((model["seg_head"], model["n_classes"]),
                        (model["kp_head"], model["n_keypoints"] * 3),
                        (model["ctr_head"], 3)):
        c = c0
        for wd in list(widths) + [out]:
            f += _conv(n, c, wd)
            c = wd
    return f


def forward_flops(model: Dict) -> float:
    """One frame's forward FLOPs of FFB6D's literal published graph."""
    return (image_flops(model) + point_flops(model) + fusion_flops(model)
            + heads_flops(model))


def knn_work(query_shape, cand_shape, k: int) -> Tuple[float, float]:
    """A k-NN search of (B, Q, 3) queries among (B, C, 3) candidates:
    bytes the queries, the candidates and the (B, Q, k) int32 indices
    once; 8 flops (a direct-form d^2) every query-candidate pair."""
    b, q, _ = query_shape
    c = cand_shape[1]
    return b * (q * 12 + c * 12 + q * k * 4), float(b * q * c * D2_FLOPS)
