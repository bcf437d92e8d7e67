"""Plain reference of the PVN3D network: the literal published graph in
float32, as a function of a state dict.

ethnhe/PVN3D ``pvn3d/lib/pvn3d.py`` (image and point branches, DenseFusion,
three heads), ``pspnet.py`` (Modified_PSPNet: PSP pyramid, three 2x
bilinear upsample stages with PReLU), ``extractors.py`` (ResNet34 with
output stride 8) and the PointNet++ MSG of ``pointnet2_utils``: the dense
CNN tail at every pixel, the embedding gathered at each point's pixel,
the fusion's global feature broadcast to every point.  Weights are read
by the reference checkpoint's keys.  Plain ``torch.nn.functional`` ops,
no kernel, no restructure; the point operations come from
``perfbench/reference/ops.py``.

Train mode normalises by batch statistics (biased variance) and applies
the dropout masks it is given; eval mode reads the running statistics.
``low_precision`` rounds the operands of every convolution and dense layer
to float8 e4m3 (one scale a tensor, float32 accumulation): the control,
the precision below the configuration's bfloat16.  ``checkpoint``
recomputes each stage in the backward, so a float32 batch of 24 fits.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from perfbench.reference import ops

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Reference:
    def __init__(self, model_cfg: Dict, sd: Dict[str, torch.Tensor],
                 train: bool = False, low_precision: bool = False,
                 checkpoint: bool = False):
        self.cfg = model_cfg
        self.sd = sd
        self.train = train
        self.lowp = low_precision
        self.ckpt = checkpoint

    # -- layers ------------------------------------------------------------
    def _q(self, x):
        return _fp8(x) if self.lowp else x

    def conv(self, x, key, stride=1, padding=0, dilation=1):
        w = self.sd[key + ".weight"]
        b = self.sd.get(key + ".bias")
        return F.conv2d(self._q(x), self._q(w), b, stride, padding, dilation)

    def dense(self, x, key):
        """A 1x1 conv weight (O, I, 1[, 1]) on channels-last x (..., I)."""
        w = self.sd[key + ".weight"]
        b = self.sd.get(key + ".bias")
        return F.linear(self._q(x), self._q(w.reshape(w.shape[0], -1)), b)

    def bn(self, x, key, channel_dim=-1):
        dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if self.train:
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
        else:
            mean = self.sd[key + ".running_mean"]
            var = self.sd[key + ".running_var"]
        inv = torch.rsqrt(var + 1e-5) * self.sd[key + ".weight"]
        return ((x - mean.reshape(shape)) * inv.reshape(shape)
                + self.sd[key + ".bias"].reshape(shape))

    def _stage(self, fn, *args):
        if self.ckpt and torch.is_grad_enabled():
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- image branch --------------------------------------------------------
    def _block(self, x, key, stride, downsample):
        y = F.relu(self.bn(self.conv(x, key + ".conv1", stride, 1),
                           key + ".bn1", 1))
        y = self.bn(self.conv(y, key + ".conv2", 1, 1), key + ".bn2", 1)
        res = x
        if downsample:
            res = self.bn(self.conv(x, key + ".downsample.0", stride),
                          key + ".downsample.1", 1)
        return F.relu(y + res)

    def _resnet_stage(self, x, s, planes, stride):
        p = "cnn.model.feats"
        for b in range(self.cfg["cnn"]["backbone_layers"][s]):
            first = b == 0
            down = first and (stride != 1 or x.shape[1] != planes)
            x = self._block(x, f"{p}.layer{s + 1}.{b}",
                            stride if first else 1, down)
        return x

    def _stem(self, rgb):
        p = "cnn.model.feats"
        x = F.relu(self.bn(self.conv(rgb.permute(0, 3, 1, 2), p + ".conv1",
                                     2, 3), p + ".bn1", 1))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def _psp(self, x):
        p = "cnn.model.psp"
        h, w = x.shape[-2:]
        priors = []
        for i, s in enumerate(self.cfg["cnn"]["psp_sizes"]):
            y = self.conv(F.adaptive_avg_pool2d(x, s), f"{p}.stages.{i}.1")
            priors.append(F.interpolate(y, size=(h, w), mode="bilinear",
                                        align_corners=False))
        return F.relu(self.conv(torch.cat(priors + [x], 1),
                                p + ".bottleneck"))

    def _up(self, x, k):
        p = f"cnn.model.up_{k}.conv"
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        x = self.bn(self.conv(x, p + ".1", 1, 1), p + ".2", 1)
        return F.prelu(x, self.sd[p + ".3.weight"])

    def image_branch(self, rgb, masks):
        cnn = self.cfg["cnn"]
        x = self._stage(self._stem, rgb)
        for s, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 1),
                                              (512, 1))):
            x = self._stage(self._resnet_stage, x, s, planes, stride)
        x = self._stage(self._psp, x)
        masks = list(masks or [])
        if self.train:
            x = x * masks.pop(0) / (1.0 - cnn["dropout_psp"])
        for k in range(1, len(cnn["up_channels"]) + 1):
            x = self._stage(self._up, x, k)
            if self.train and k < len(cnn["up_channels"]):
                x = x * masks.pop(0) / (1.0 - cnn["dropout_up"])
        emb = self.conv(x, "cnn.model.final.0").permute(0, 2, 3, 1)
        return emb

    # -- point branch --------------------------------------------------------
    def mlp(self, x, key, n_layers):
        for k in range(n_layers):
            x = F.relu(self.bn(self.dense(x, f"{key}.layer{k}.conv"),
                               f"{key}.layer{k}.normlayer.bn"))
        return x

    def _sa(self, li, xyz, feats, new_xyz):
        lv = self.cfg["pointnet2"]["sa_levels"][li]
        idxs = ops.ball_query(lv["radii"], lv["nsamples"], xyz, new_xyz)
        b = xyz.shape[0]
        outs = []
        for j, (idx, widths) in enumerate(zip(idxs, lv["mlps"])):
            m, ns = idx.shape[1:]
            flat = idx.reshape(b, m * ns)

            def group(t):
                return torch.gather(t, 1, flat[..., None].expand(
                    -1, -1, t.shape[-1])).reshape(b, m, ns, -1)
            g = group(xyz) - new_xyz[:, :, None, :]
            if feats is not None:
                g = torch.cat([g, group(feats)], -1)
            outs.append(self.mlp(g, f"pointnet2.SA_modules.{li}.mlps.{j}",
                                 len(widths)).amax(dim=2))
        return torch.cat(outs, -1)

    def _fp(self, li, unknown, known, unknown_feats, known_feats):
        x = ops.three_interpolate(unknown, known, known_feats)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], -1)
        return self.mlp(x, f"pointnet2.FP_modules.{li}.mlp",
                        len(self.cfg["pointnet2"]["fp_mlps"][li]))

    def point_branch(self, pointcloud):
        pn = self.cfg["pointnet2"]
        xyz = pointcloud[..., :3].float().contiguous()
        l_xyz = [xyz]
        l_feats = [pointcloud[..., 3:]]
        for li, lv in enumerate(pn["sa_levels"]):
            if li == 0:
                idx = ops.fps(xyz, lv["npoint"])
                new_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1,
                                                                      3))
            else:
                # Greedy FPS is prefix consistent: each level takes the
                # previous level's first picks.
                new_xyz = l_xyz[li][:, :lv["npoint"]]
            l_feats.append(self._stage(self._sa, li, l_xyz[li], l_feats[li],
                                       new_xyz))
            l_xyz.append(new_xyz)
        for li in range(len(pn["fp_mlps"]) - 1, -1, -1):
            l_feats[li] = self._stage(self._fp, li, l_xyz[li], l_xyz[li + 1],
                                      l_feats[li], l_feats[li + 1])
        return l_feats[0]

    # -- fusion and heads ----------------------------------------------------
    def _head(self, fused, name, n_hidden, output=True):
        """A head's hidden layers and, with ``output``, its last layer."""
        x = fused
        for k in range(n_hidden):
            x = F.relu(self.bn(self.dense(x, f"{name}.{k}.conv"),
                               f"{name}.{k}.normlayer.bn"))
        return self.dense(x, f"{name}.{n_hidden}.conv") if output else x

    def _fusion(self, rgb_emb, cld_emb):
        feat_1 = torch.cat([rgb_emb, cld_emb], -1)
        rgb = F.relu(self.dense(rgb_emb, "rgbd_feat.conv2_rgb"))
        cld = F.relu(self.dense(cld_emb, "rgbd_feat.conv2_cld"))
        rgbd = F.relu(self.dense(feat_1, "rgbd_feat.conv3"))
        rgbd = F.relu(self.dense(rgbd, "rgbd_feat.conv4"))
        glob = rgbd.mean(dim=1, keepdim=True).expand_as(rgbd)
        return torch.cat([feat_1, rgb, cld, glob], -1)

    def forward(self, pointcloud, rgb, choose,
                masks: Optional[List[torch.Tensor]] = None):
        """pointcloud (B, N, 9), rgb (B, H, W, 3), choose (B, N) ->
        seg_logits (B, N, n_classes), kp_offsets (B, n_kps, N, 3),
        ctr_offsets (B, 1, N, 3), and the seg head's last hidden layer
        seg_hidden (B, N, C)."""
        cfg = self.cfg
        b, n, _ = pointcloud.shape
        emb = self.image_branch(rgb.float(), masks)
        rgb_emb = torch.gather(emb.reshape(b, -1, emb.shape[-1]), 1,
                               choose.long()[..., None].expand(
                                   -1, -1, emb.shape[-1]))
        cld_emb = self.point_branch(pointcloud.float())
        fused = self._stage(self._fusion, rgb_emb, cld_emb)
        seg_hidden = self._stage(self._head, fused, "SEG_layer",
                                 len(cfg["seg_head"]), False)
        seg = self.dense(seg_hidden, f"SEG_layer.{len(cfg['seg_head'])}.conv")
        kp = self._stage(self._head, fused, "KpOF_layer",
                         len(cfg["kp_head"]))
        ctr = self._stage(self._head, fused, "CtrOf_layer",
                          len(cfg["ctr_head"]))
        return {"seg_logits": seg, "seg_hidden": seg_hidden,
                "kp_offsets": kp.reshape(b, n, -1, 3).permute(0, 2, 1, 3),
                "ctr_offsets": ctr.reshape(b, n, 1, 3).permute(0, 2, 1, 3)}
