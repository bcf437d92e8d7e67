"""The full PVN3D model of the port: CNN + PointNet++ + DenseFusion + heads.

Port of the JAX package's ``models/pvn3d.py``, in eval mode (the state a
new model is in) and, after ``model.train()``, in train mode: the image
branch's embeddings at each point's ``choose`` pixel (pvn3d.py:172-178),
the point branch, DenseFusion and the three heads.

In eval mode it runs the JAX package's restructured graph where the
config sets it (every restructure is on by default): the sparse CNN tail
(``sparse_cnn``, JAX's rule), the fused upsample stages, the SA/FP
precompute-first point branch and, with ``head_split_global``, the
fusion's global context kept apart (``DenseFusion(split_global)``), so
each head's first layer multiplies it once a frame (``_split_dense``).
Train mode keeps the literal dense graph.  Module names and the
parameters are the same in both graphs and are the reference
checkpoint's top-level keys (``cnn.model``, ``pointnet2``, ``rgbd_feat``,
``SEG_layer``, ``KpOF_layer``, ``CtrOf_layer``), so ``state_dict()``
loads a reference checkpoint and ``utils.weights.from_jax_variables``
maps JAX weights in.  The fusion and the heads take their input widths
from the two branches' (``cnn.embedding_dim``, ``fp_mlps[0][-1]``), not
from ``fusion_dim``, as the JAX package's modules infer them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.config import ModelConfig
from pvn3d_tpu_torch.models.layers import Conv1x1BN, linear
from pvn3d_tpu_torch.models.pointnet2 import PointNet2MSG
from pvn3d_tpu_torch.models.pspnet import PSPNetEmbedding
from pvn3d_tpu_torch.ops.grouping import QUERY_COMPUTE, QUERY_MODES
from pvn3d_tpu_torch.ops.interpolate import INTERP_MODES
from pvn3d_tpu_torch.utils.profiling import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype of ``cfg``; raise on settings the JAX package
    does not run either: an unknown neighbour mode or query dtype, a
    ``fps_groups`` that does not divide the point count and every level's
    npoint, a "pallas" query with no capacity."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port "
                         f"runs {sorted(_DTYPES)}")
    pn = cfg.pointnet2
    if pn.query_mode not in QUERY_MODES:
        raise ValueError(f"query_mode {pn.query_mode!r}: one of "
                         f"{QUERY_MODES}")
    if pn.interp_mode not in INTERP_MODES:
        raise ValueError(f"interp_mode {pn.interp_mode!r}: one of "
                         f"{INTERP_MODES}")
    if pn.query_compute not in QUERY_COMPUTE:
        raise ValueError(f"query_compute {pn.query_compute!r}: one of "
                         f"{QUERY_COMPUTE}")
    if pn.query_mode == "pallas" and pn.query_capacity < 1:
        raise ValueError(f"query_capacity {pn.query_capacity}: the 'pallas' "
                         f"query keeps at least 1 hit per residue class")
    sizes = (cfg.n_sample_points,) + tuple(lv.npoint for lv in pn.sa_levels)
    if pn.fps_groups < 1 or any(n % pn.fps_groups for n in sizes):
        raise ValueError(f"fps_groups {pn.fps_groups} must divide the point "
                         f"count and every level's npoint {sizes}")
    return _DTYPES[cfg.compute_dtype]


class DenseFusion(nn.Module):
    """Per-point RGB-D fusion (pvn3d.py:157-182): (B, N, emb_rgb) and
    (B, N, emb_cld) -> (B, N, emb_rgb + emb_cld + 512 + 1024) = [rgb, cld,
    relu(rgb'), relu(cld'), global mean].  Each conv's input width comes
    from the branch it reads, as the JAX package infers it."""

    def __init__(self, emb_rgb: int = 128, emb_cld: int = 128):
        super().__init__()
        self.conv2_rgb = nn.Conv1d(emb_rgb, 256, 1)
        self.conv2_cld = nn.Conv1d(emb_cld, 256, 1)
        self.conv3 = nn.Conv1d(emb_rgb + emb_cld, 512, 1)
        self.conv4 = nn.Conv1d(512, 1024, 1)
        self.out_dim = emb_rgb + emb_cld + 2 * 256 + 1024

    def forward(self, rgb_emb: torch.Tensor, cld_emb: torch.Tensor,
                split_global: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The (B, N, out_dim) fused features, or with ``split_global``
        the pair (local (B, N, out_dim - 1024), global (B, 1, 1024))
        without the broadcast and concat (JAX ``:29-65``)."""
        feat_1 = torch.cat([rgb_emb, cld_emb], dim=-1)
        rgb = F.relu(linear(rgb_emb, self.conv2_rgb.weight,
                            self.conv2_rgb.bias))
        cld = F.relu(linear(cld_emb, self.conv2_cld.weight,
                            self.conv2_cld.bias))
        rgbd = F.relu(linear(feat_1, self.conv3.weight, self.conv3.bias))
        rgbd = F.relu(linear(rgbd, self.conv4.weight, self.conv4.bias))
        glob = rgbd.mean(dim=1, keepdim=True)
        if split_global:
            return torch.cat([feat_1, rgb, cld], dim=-1), glob
        return torch.cat([feat_1, rgb, cld, glob.expand_as(rgbd)], dim=-1)


def _split_dense(weight: torch.Tensor, local: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """A head's first 1x1 conv on the split fusion output: ``local @ K[:d]
    + g @ K[d:]`` (JAX ``_SplitDense``, ``:68-90``), the global term once
    a frame.  The conv has no bias (the JAX one is folded into the BN's
    running mean, ``utils/weights.py``)."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(local.dtype)
    d = local.shape[-1]
    return F.linear(local, w[:, :d]) + F.linear(g, w[:, d:])


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

    def forward(self, x, bn_momentum=0.1) -> torch.Tensor:
        """``x``: (B, N, C), or DenseFusion's (local, global) pair, which
        the first layer takes through ``_split_dense``."""
        for k in range(self.n_hidden):
            layer = getattr(self, str(k))
            if k == 0 and isinstance(x, tuple):
                x = layer.finish(_split_dense(layer.conv.weight, *x),
                                 bn_momentum)
            else:
                x = layer(x, bn_momentum)
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
    auxiliary ``rgb_seg`` log-probabilities: (B, H, W, n_classes) from the
    dense CNN tail, (B, N, n_classes) from the sparse one.

    ``sparse_cnn`` (an attribute, JAX ``:165-167``): True or False forces
    the CNN tail; None takes the sparse one exactly when the model is in
    eval mode, ``cfg.sparse_cnn_eval`` is set and the batch is 1.
    """

    def __init__(self, cfg: ModelConfig, sparse_cnn: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        self.sparse_cnn = sparse_cnn
        self.dtype = check_supported(cfg)
        cc = cfg.cnn
        self.cnn = nn.Module()
        self.cnn.model = PSPNetEmbedding(
            n_classes=cfg.n_classes, sizes=cc.psp_sizes,
            psp_features=cc.psp_features, psp_out=cc.psp_out,
            up_channels=cc.up_channels, embedding_dim=cc.embedding_dim,
            backbone_layers=cc.backbone_layers, dropout_psp=cc.dropout_psp,
            dropout_up=cc.dropout_up, fuse_up=cc.fuse_upsample)
        self.pointnet2 = PointNet2MSG(cfg.pointnet2)
        self.rgbd_feat = DenseFusion(cc.embedding_dim,
                                     cfg.pointnet2.fp_mlps[0][-1])
        fused = self.rgbd_feat.out_dim
        self.SEG_layer = PredictionHead(fused, cfg.seg_head, cfg.n_classes)
        self.KpOF_layer = PredictionHead(fused, cfg.kp_head,
                                         cfg.n_keypoints * 3)
        self.CtrOf_layer = PredictionHead(fused, cfg.ctr_head, 3)
        self.eval()

    def uses_sparse_tail(self, batch: int) -> bool:
        """Whether a forward of ``batch`` frames takes the sparse CNN
        tail (``sparse_cnn``'s rule)."""
        if self.sparse_cnn is not None:
            return self.sparse_cnn
        return not self.training and self.cfg.sparse_cnn_eval and batch == 1

    def forward(self, pointcloud: torch.Tensor, rgb: torch.Tensor,
                choose: torch.Tensor, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None,
                global_batch: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """``global_batch``: the frames of the whole batch when these are
        one rank's rows of it; the CNN tail is chosen on it, as JAX
        chooses on the global shape."""
        cfg = self.cfg
        b, n, _ = pointcloud.shape
        with annotate("pvn3d.image_branch"):
            if self.uses_sparse_tail(global_batch or b):
                rgb_emb, rgb_seg = self.cnn.model(
                    rgb.to(self.dtype), bn_momentum, generator, choose=choose)
            else:
                emb_map, rgb_seg = self.cnn.model(rgb.to(self.dtype),
                                                  bn_momentum, generator)
                h, w, di = emb_map.shape[1:]
                rgb_emb = torch.gather(
                    emb_map.reshape(b, h * w, di), 1,
                    choose.long()[..., None].expand(-1, -1, di))
        with annotate("pvn3d.point_branch"):
            cld_emb = self.pointnet2(pointcloud, self.dtype, bn_momentum)
        with annotate("pvn3d.heads"):
            fused = self.rgbd_feat(
                rgb_emb, cld_emb,
                split_global=not self.training and cfg.head_split_global)
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
