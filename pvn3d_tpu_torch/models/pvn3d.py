"""The full PVN3D model of the port: CNN + PointNet++ + DenseFusion + heads.

Port of the JAX package's ``models/pvn3d.py`` on the dense reference
graph (``PVN3D(cfg, sparse_cnn=False)``), in eval mode (the state a new
model is in) and, after ``model.train()``, in train mode: the image
branch's embedding map gathered at each point's ``choose`` pixel
(pvn3d.py:172-178), the point branch, DenseFusion with the literal
global-feature concat, and the three heads.  ``head_split_global`` and the
sparse CNN tail give the same outputs up to summation order and are not
ported.  Module names are the reference checkpoint's top-level keys
(``cnn.model``, ``pointnet2``, ``rgbd_feat``, ``SEG_layer``,
``KpOF_layer``, ``CtrOf_layer``), so ``state_dict()`` loads a reference
checkpoint and ``utils.weights.from_jax_variables`` maps JAX weights in.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.config import ModelConfig
from pvn3d_tpu_torch.models.layers import Conv1x1BN, linear
from pvn3d_tpu_torch.models.pointnet2 import PointNet2MSG
from pvn3d_tpu_torch.models.pspnet import PSPNetEmbedding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# Neighbour modes whose JAX arms are not the exact ones the port runs: the
# approximate top-k ball query, the capacity-limited Pallas ball query
# (exact only while no residue class holds more than ``query_capacity`` of
# the first k hits) and the approximate 3-NN.
_UNPORTED_QUERY_MODES = ("approx", "pallas")
_UNPORTED_INTERP_MODES = ("approx",)


def check_supported(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype of ``cfg``; raise on settings the port does not
    run (grouped FPS, bf16 distance matrices, neighbour modes other than
    the exact ones)."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port "
                         f"runs {sorted(_DTYPES)}")
    if cfg.pointnet2.fps_groups != 1:
        raise NotImplementedError("the port runs exact FPS (fps_groups=1)")
    if cfg.pointnet2.query_compute != "f32":
        raise NotImplementedError("the port computes every d^2 in float32")
    if cfg.pointnet2.query_mode in _UNPORTED_QUERY_MODES:
        raise NotImplementedError(
            f"query_mode {cfg.pointnet2.query_mode!r}: the port runs the "
            f"exact ball query ('auto' or 'exact')")
    if cfg.pointnet2.interp_mode in _UNPORTED_INTERP_MODES:
        raise NotImplementedError(
            f"interp_mode {cfg.pointnet2.interp_mode!r}: the port runs the "
            f"exact 3-NN ('auto', 'exact' or 'pallas')")
    return _DTYPES[cfg.compute_dtype]


class DenseFusion(nn.Module):
    """Per-point RGB-D fusion (pvn3d.py:157-182): (B, N, 128) x 2 ->
    (B, N, 1792) = [rgb, cld, relu(rgb'), relu(cld'), global mean]."""

    def __init__(self, emb: int = 128):
        super().__init__()
        self.conv2_rgb = nn.Conv1d(emb, 256, 1)
        self.conv2_cld = nn.Conv1d(emb, 256, 1)
        self.conv3 = nn.Conv1d(2 * emb, 512, 1)
        self.conv4 = nn.Conv1d(512, 1024, 1)

    def forward(self, rgb_emb: torch.Tensor,
                cld_emb: torch.Tensor) -> torch.Tensor:
        feat_1 = torch.cat([rgb_emb, cld_emb], dim=-1)
        rgb = F.relu(linear(rgb_emb, self.conv2_rgb.weight,
                            self.conv2_rgb.bias))
        cld = F.relu(linear(cld_emb, self.conv2_cld.weight,
                            self.conv2_cld.bias))
        rgbd = F.relu(linear(feat_1, self.conv3.weight, self.conv3.bias))
        rgbd = F.relu(linear(rgbd, self.conv4.weight, self.conv4.bias))
        glob = rgbd.mean(dim=1, keepdim=True).expand_as(rgbd)
        return torch.cat([feat_1, rgb, cld, glob], dim=-1)


class PredictionHead(nn.Module):
    """Dense + BN + ReLU stack with a linear output (pvn3d.py:245-267);
    children ``0 .. len(widths)`` as in the reference ``Seq`` builder."""

    def __init__(self, c_in: int, widths: Sequence[int], out_dim: int):
        super().__init__()
        for k, w in enumerate(widths):
            self.add_module(str(k), Conv1x1BN(c_in, w, conv_dims=1))
            c_in = w
        out = nn.Module()
        out.conv = nn.Conv1d(c_in, out_dim, 1)
        self.add_module(str(len(widths)), out)
        self.n_hidden = len(widths)

    def forward(self, x: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        for k in range(self.n_hidden):
            x = getattr(self, str(k))(x, bn_momentum)
        out = getattr(self, str(self.n_hidden)).conv
        return linear(x, out.weight, out.bias)


class PVN3D(nn.Module):
    """Full model.  A new model is in eval mode (running BN statistics, no
    dropout); ``model.train()`` switches to batch statistics, updated with
    ``bn_momentum``, and to the image branch's dropouts, drawn from
    ``generator``.

    ``forward(pointcloud (B, N, 9), rgb (B, H, W, 3), choose (B, N))``
    returns ``seg_logits`` (B, N, n_classes), ``kp_offsets``
    (B, n_kps, N, 3), ``ctr_offsets`` (B, 1, N, 3), all float32, and the
    auxiliary ``rgb_seg`` (B, H, W, n_classes) log-probabilities.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = check_supported(cfg)
        cc = cfg.cnn
        self.cnn = nn.Module()
        self.cnn.model = PSPNetEmbedding(
            n_classes=cfg.n_classes, sizes=cc.psp_sizes,
            psp_features=cc.psp_features, psp_out=cc.psp_out,
            up_channels=cc.up_channels, embedding_dim=cc.embedding_dim,
            backbone_layers=cc.backbone_layers, dropout_psp=cc.dropout_psp,
            dropout_up=cc.dropout_up)
        self.pointnet2 = PointNet2MSG(cfg.pointnet2)
        self.rgbd_feat = DenseFusion(cc.embedding_dim)
        self.SEG_layer = PredictionHead(cfg.fusion_dim, cfg.seg_head,
                                        cfg.n_classes)
        self.KpOF_layer = PredictionHead(cfg.fusion_dim, cfg.kp_head,
                                         cfg.n_keypoints * 3)
        self.CtrOf_layer = PredictionHead(cfg.fusion_dim, cfg.ctr_head, 3)
        self.eval()

    def forward(self, pointcloud: torch.Tensor, rgb: torch.Tensor,
                choose: torch.Tensor, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, n, _ = pointcloud.shape
        emb_map, rgb_seg = self.cnn.model(rgb.to(self.dtype), bn_momentum,
                                          generator)
        h, w, di = emb_map.shape[1:]
        rgb_emb = torch.gather(
            emb_map.reshape(b, h * w, di), 1,
            choose.long()[..., None].expand(-1, -1, di))
        cld_emb = self.pointnet2(pointcloud, self.dtype, bn_momentum)
        fused = self.rgbd_feat(rgb_emb, cld_emb)
        seg = self.SEG_layer(fused, bn_momentum)
        kp = self.KpOF_layer(fused, bn_momentum).reshape(
            b, n, cfg.n_keypoints, 3)
        ctr = self.CtrOf_layer(fused, bn_momentum).reshape(b, n, 1, 3)
        return {
            "seg_logits": seg.float(),
            "kp_offsets": kp.permute(0, 2, 1, 3).float(),
            "ctr_offsets": ctr.permute(0, 2, 1, 3).float(),
            "rgb_seg": rgb_seg,
        }
