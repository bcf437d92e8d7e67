"""Plain reference of FFB6D (He et al., CVPR 2021): the literal published
graph in float32, as a function of a state dict, with its frame build in
the sample's random order and its neighbour index by brute force.

ethnhe/FFB6D ``ffb6d/models/ffb6d.py`` (the stage loop and the fusion),
``models/RandLA/RandLANet.py`` (``fc0``, ``Dilated_res_block``,
``Building_block``, ``Att_pooling``, the decoder convs), ``pspnet.py`` and
``extractors.py`` (ResNet34 at output stride 8, PSP, the 2x upsample
stages, ``final``: a 1x1 conv and a log-softmax over channels, applied
twice), and the index build of ``datasets/ycb/ycb_dataset.py``.  The
maps are NCHW; every 1x1 conv is a dense layer on channels-last rows.
Every RandLA and fusion conv is bias-free + BN + LeakyReLU(0.2), the
default of the RandLA ``pytorch_utils.Conv2d``; the heads' hidden layers
take ReLU.  The dense image tail runs at every pixel and the embedding is
gathered at each point's pixel; each fusion conv reads the literal
concatenation.  Weights are read by the port's ``state_dict`` keys.
Imports nothing of the port.

``low_precision`` rounds the operands of every convolution and dense
layer to float8 e4m3, as ``reference/model.py`` does: the control, one
precision below the configuration's bfloat16.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import frame as rframe
from perfbench.reference import knn as rknn
from perfbench.reference.model import Reference

SLOPE = 0.2


def build(rgb: torch.Tensor, depth: torch.Tensor, cam_k: torch.Tensor,
          priorities: torch.Tensor, n_sample: int, cam_scale: float,
          fill: bool, low_precision: bool = False):
    """Raw frames -> pointcloud (B, N, 9) [xyz | rgb | normal], choose
    (B, N) int64 in descending priority (the source's shuffled sample:
    its levels are leading quarters), and the cloud map (B, H, W, 3) of
    the filled depth.  ``low_precision`` stores the filled depth in
    bfloat16 first (the control)."""
    b, h, w = depth.shape
    d = depth.float()
    if fill:
        d = rframe.fill_missing(d, cam_scale)
    depth_m = d / cam_scale
    if low_precision:
        depth_m = depth_m.to(torch.bfloat16).float()
    cloud_map, valid = rframe.depth_to_cloud_map(depth_m, cam_k)
    nrm_map = rframe.normals_from_depth_map(depth_m, cam_k, 1.0)
    score = torch.where(valid.reshape(b, h * w), priorities.float(), -1.0)
    top, sel = torch.sort(score, dim=1, descending=True, stable=True)
    top, sel = top[:, :n_sample], sel[:, :n_sample]
    choose = torch.where(top > 0.0, sel, sel[:, :1])
    idx = choose[..., None].expand(-1, -1, 3)

    def gather(m):
        return torch.gather(m.reshape(b, -1, 3), 1, idx)
    cloud = torch.cat([gather(cloud_map), gather(rgb.float()),
                       gather(nrm_map)], dim=-1)
    return cloud, choose, cloud_map


def strided_maps(cloud_map: torch.Tensor, strides) -> Dict[int, torch.Tensor]:
    """{s: the (B, H/s * W/s, 3) map points at pixels [::s, ::s]}."""
    b = cloud_map.shape[0]
    return {s: cloud_map[:, ::s, ::s].reshape(b, -1, 3) for s in strides}


def index(xyz: torch.Tensor, maps: Dict[int, torch.Tensor], model: Dict
          ) -> Dict[str, List[torch.Tensor]]:
    """The 22 searches of the source's index build, by brute force:
    ``nei``, ``sub``, ``interp``, ``r2p_ds``, ``p2r_ds`` (4 each),
    ``r2p_up``, ``p2r_up`` (3 each), and the levels ``xyz``."""
    rl = model["randla"]
    k = rl["k_n"]
    levels = [xyz.float()]
    for r in rl["sub_sampling_ratio"]:
        levels.append(levels[-1][:, :levels[-1].shape[1] // r])
    out = {name: [] for name in ("nei", "sub", "interp", "r2p_ds", "p2r_ds",
                                 "r2p_up", "p2r_up")}
    for i, s in enumerate(model["ds_strides"]):
        cld, sub = levels[i], levels[i + 1]
        nei = rknn.knn(cld, cld, k)
        out["nei"].append(nei)
        out["sub"].append(nei[:, :sub.shape[1]])
        out["interp"].append(rknn.knn(cld, sub, 1)[..., 0])
        out["r2p_ds"].append(rknn.knn(sub, maps[s], k))
        out["p2r_ds"].append(rknn.knn(maps[s], sub, 1)[..., 0])
    n_ds = len(model["ds_strides"])
    for j, s in enumerate(model["up_strides"]):
        cld = levels[n_ds - j - 1]
        out["r2p_up"].append(rknn.knn(cld, maps[s], k))
        out["p2r_up"].append(rknn.knn(maps[s], cld, 1)[..., 0])
    out["xyz"] = levels
    return out


def _gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, C) at (B, ...) indices -> (B, ..., C)."""
    b, _, c = feats.shape
    flat = idx.reshape(b, -1).long()
    out = torch.gather(feats, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


class FFB6DReference(Reference):
    """``forward(pointcloud, rgb, choose, idx)`` -> seg_logits, kp_offsets,
    ctr_offsets (the PVN3D contract) and seg_hidden, in float32."""

    def __init__(self, model_cfg: Dict, sd: Dict[str, torch.Tensor],
                 low_precision: bool = False):
        super().__init__(model_cfg, sd, train=False,
                         low_precision=low_precision)

    # -- image branch (NCHW) -------------------------------------------------
    def _image_ds(self, i, x):
        p = "cnn.feats"
        if i == 0:
            x = F.relu(self.bn(self.conv(x, p + ".conv1", 2, 3),
                               p + ".bn1", 1))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            return self._layer(x, 0, 64, 1)
        if i == 1:
            return self._layer(x, 1, 128, 2)
        if i == 2:
            return self._layer(self._layer(x, 2, 256, 1), 3, 512, 1)
        h, w = x.shape[-2:]
        priors = []
        for j, s in enumerate(self.cfg["cnn"]["psp_sizes"]):
            y = self.conv(F.adaptive_avg_pool2d(x, s),
                          f"cnn.psp.stages.{j}.1")
            priors.append(F.interpolate(y, size=(h, w), mode="bilinear",
                                        align_corners=False))
        return F.relu(self.conv(torch.cat(priors + [x], 1),
                                "cnn.psp.bottleneck"))

    def _layer(self, x, s, planes, stride):
        for b in range(self.cfg["cnn"]["backbone_layers"][s]):
            first = b == 0
            down = first and (stride != 1 or x.shape[1] != planes)
            x = self._block(x, f"cnn.feats.layer{s + 1}.{b}",
                            stride if first else 1, down)
        return x

    def _upsample(self, x, k):
        p = f"cnn.up_{k}.conv"
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        x = self.bn(self.conv(x, p + ".1", 1, 1), p + ".2", 1)
        return F.prelu(x, self.sd[p + ".3.weight"])

    def _final(self, x):
        return F.log_softmax(self.conv(x, "cnn.final.0"), dim=1)

    def _image_up(self, i, x):
        if i < 2:
            return self._upsample(x, i + 1)
        return self._final(x)

    # -- point branch (channels last) ------------------------------------------
    def _cba(self, x, key, act=True):
        y = self.bn(self.dense(x, key + ".conv"), key + ".bn")
        return F.leaky_relu(y, SLOPE) if act else y

    def _att_pool(self, x, key):
        scores = F.softmax(self.dense(x, key + ".fc"), dim=2)
        return self._cba((x * scores).sum(dim=2), key + ".mlp")

    def _rel_pos(self, xyz, nei):
        nxyz = _gather(xyz, nei)
        tile = xyz[:, :, None, :].expand_as(nxyz)
        rel = tile - nxyz
        dis = torch.sqrt((rel ** 2).sum(dim=-1, keepdim=True))
        return torch.cat([dis, rel, tile, nxyz], dim=-1)

    def _res_block(self, i, feats, xyz, nei):
        p = f"rndla.dilated_res_blocks.{i}"
        f_pc = self._cba(feats, p + ".mlp1")
        f_xyz = self._cba(self._rel_pos(xyz, nei), p + ".lfa.mlp1")
        agg = self._att_pool(torch.cat([_gather(f_pc, nei), f_xyz], -1),
                             p + ".lfa.att_pooling_1")
        f_xyz = self._cba(f_xyz, p + ".lfa.mlp2")
        agg = self._att_pool(torch.cat([_gather(agg, nei), f_xyz], -1),
                             p + ".lfa.att_pooling_2")
        f_pc = self._cba(agg, p + ".mlp2", act=False)
        return F.leaky_relu(f_pc + self._cba(feats, p + ".shortcut",
                                             act=False), SLOPE)

    # -- fusion ------------------------------------------------------------------
    def _fuse(self, kind, i, rgb0, p0, p2r, r2p):
        b, c, h, w = rgb0.shape
        pre = self._cba(p0, f"{kind}_fuse_p2r_pre_layers.{i}")
        p2r_emb = _gather(pre, p2r).permute(0, 2, 1).reshape(b, -1, h, w)
        rgb = torch.cat([rgb0, p2r_emb], 1).permute(0, 2, 3, 1)
        rgb = self._cba(rgb, f"{kind}_fuse_p2r_fuse_layers.{i}")
        rows = rgb0.permute(0, 2, 3, 1).reshape(b, h * w, c)
        r2p_emb = self._cba(_gather(rows, r2p).amax(dim=2),
                            f"{kind}_fuse_r2p_pre_layers.{i}")
        p = self._cba(torch.cat([p0, r2p_emb], -1),
                      f"{kind}_fuse_r2p_fuse_layers.{i}")
        return rgb.permute(0, 3, 1, 2), p

    def forward(self, pointcloud, rgb, choose, idx):
        cfg = self.cfg
        b, n, _ = pointcloud.shape
        x = rgb.float().permute(0, 3, 1, 2)
        p = self._cba(pointcloud.float(), "rndla.fc0")
        ds_emb = []
        for i in range(len(cfg["ds_strides"])):
            rgb0 = self._image_ds(i, x)
            enc = self._res_block(i, p, idx["xyz"][i], idx["nei"][i])
            p0 = _gather(enc, idx["sub"][i]).amax(dim=2)
            if i == 0:
                ds_emb.append(enc)
            x, p = self._fuse("ds", i, rgb0, p0, idx["p2r_ds"][i],
                              idx["r2p_ds"][i])
            ds_emb.append(p)
        n_ds = len(cfg["ds_strides"])
        n_up = len(cfg["up_strides"])
        for j in range(n_up):
            rgb0 = self._image_up(j, x)
            interp = _gather(p, idx["interp"][n_ds - j - 1])
            p0 = self._cba(torch.cat([ds_emb[-j - 2], interp], -1),
                           f"rndla.decoder_blocks.{j}")
            x, p = self._fuse("up", j, rgb0, p0, idx["p2r_up"][j],
                              idx["r2p_up"][j])
        x = self._final(self._upsample(x, len(cfg["cnn"]["up_channels"])))
        emb = x.permute(0, 2, 3, 1).reshape(b, -1, x.shape[1])
        rgb_emb = _gather(emb, choose)
        p = self._cba(torch.cat([ds_emb[0], _gather(p, idx["interp"][0])],
                                -1), f"rndla.decoder_blocks.{n_up}")
        fused = torch.cat([rgb_emb, p], -1)
        seg_hidden = self._head(fused, "rgbd_seg_layer",
                                len(cfg["seg_head"]), False)
        seg = self.dense(seg_hidden,
                         f"rgbd_seg_layer.{len(cfg['seg_head'])}.conv")
        kp = self._head(fused, "kp_ofst_layer", len(cfg["kp_head"]))
        ctr = self._head(fused, "ctr_ofst_layer", len(cfg["ctr_head"]))
        return {"seg_logits": seg, "seg_hidden": seg_hidden,
                "kp_offsets": kp.reshape(b, n, -1, 3).permute(0, 2, 1, 3),
                "ctr_offsets": ctr.reshape(b, n, 1, 3).permute(0, 2, 1, 3)}
