"""FFB6D (He et al., CVPR 2021; ethnhe/FFB6D ``ffb6d/models/ffb6d.py``):
the image and point branches exchanging features at every stage, in eval
and train mode.

Encoder: four image stages (stem + ``layer1`` at stride 4, ``layer2`` at
8, ``layer3`` + ``layer4`` at 8, PSP at 8; 64, 128, 512, 1024 channels)
beside four RandLA-Net blocks, each followed by random sampling to the
next point level.  Decoder: three image stages (``up_1`` at stride 4,
``up_2`` at 2, ``final`` at 2; 256, 64, 64 channels) beside three
RandLA decoder convs.  After each of the seven stages the two directions
of the fusion (``fuse``):

* points -> pixels: ``p2r_pre`` on the stage's points, each pixel of the
  stage's map takes its nearest point, ``p2r_fuse`` on [map ; gathered];
  the result feeds the next image stage;
* pixels -> points: each point max-pools the stage's pre-fusion map at
  its 16 nearest pixels (in 3-D), ``r2p_pre``, ``r2p_fuse`` on
  [points ; pooled]; the result feeds the next point stage.

Then ``up_3`` + ``final`` to full resolution (at the sampled pixels only
in eval mode at batch 1, ``PSPUpsample.sparse``: the stage is pointwise
after the resize), the last decoder conv on the full cloud, and the
three heads on [image ; points] (128 channels).  ``final`` is one module
applied twice, a 1x1 conv and a log-softmax over channels, as the
source's ``pspnet.py`` holds it.

The image modules are the port's ResNet34 / PSP ones (``cnn.*``), the
heads ``PredictionHead``; the outputs follow ``PVN3D``'s forward
contract, so ``inference.pipeline.make_pose_fn`` consumes them as they
are.  The neighbour index (``data/ffb6d_index.py``) is an argument of the
forward; the serving step builds it through ``frame_inputs``.  Each piece
opens its span: ``pvn3d.neighbour_index``, ``pvn3d.image_branch``,
``pvn3d.point_branch``, ``pvn3d.fusion`` (both directions of a stage) and
``pvn3d.heads``.  On the card in eval mode each of the eight image stages
replays a CUDA graph (``utils/graphs.py``).

Train mode (``model.train()``) takes the dense ``up_3`` + ``final`` tail
at every pixel, batch-statistics BN moved with the momentum the caller
passes per call, and the image branch's elementwise dropouts of
``models/pspnet.py`` (``dropout_psp`` after PSP, ``dropout_up`` after
``up_1`` and ``up_2``; the source's are ``Dropout2d`` at the same places),
drawn from the caller's generator; it replays no graph.  The gathers of
rows (``models/randla.py::gather_rows``) then carry their own backward.
The training step (``train/step.py``) builds the index through
``frame_inputs`` as the serving step does.

One restructure of the literal graph: ``p2r_fuse``'s product on the
concatenation is split, and its gathered half is taken on the points
before the gather (a gather of rows commutes with a product on rows), so
it multiplies ``|P|`` rows instead of every pixel's copy.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pvn3d_tpu_torch.config import FFB6DConfig
from pvn3d_tpu_torch.data.ffb6d_index import build_index
from pvn3d_tpu_torch.models.layers import dropout, linear, named_sequential
from pvn3d_tpu_torch.models.pspnet import PSPModule, PSPUpsample
from pvn3d_tpu_torch.models.pvn3d import _DTYPES, PredictionHead
from pvn3d_tpu_torch.models.randla import (ConvBNAct, RandLANet, gather_rows,
                                           nearest_interpolation,
                                           random_sample)
from pvn3d_tpu_torch.models.resnet import DilatedResNet
from pvn3d_tpu_torch.utils.graphs import Graphed
from pvn3d_tpu_torch.utils.profiling import annotate


class FFB6D(Graphed):
    """``forward(pointcloud (B, N, 9), rgb (B, H, W, 3), choose (B, N),
    index, bn_momentum, generator)`` -> ``seg_logits`` (B, N, n_classes),
    ``kp_offsets`` (B, n_kps, N, 3), ``ctr_offsets`` (B, 1, N, 3),
    float32.  The points and ``choose`` are in the sample's random order,
    and ``index`` is ``data.ffb6d_index.build_index`` of them.  A new
    model is in eval mode; ``model.train()`` switches to batch
    statistics, moved with ``bn_momentum``, and to the dropouts, drawn
    from ``generator``."""

    def __init__(self, cfg: FFB6DConfig):
        super().__init__()
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the "
                             f"port runs {sorted(_DTYPES)}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        cc, rl = cfg.cnn, cfg.randla
        slope = rl.leaky_slope
        self.cnn = nn.Module()
        self.cnn.feats = DilatedResNet(layers=cc.backbone_layers)
        self.cnn.psp = PSPModule(cc.psp_features, cc.psp_out, cc.psp_sizes)
        c = cc.psp_out
        for k, ch in enumerate(cc.up_channels, start=1):
            self.cnn.add_module(f"up_{k}", PSPUpsample(c, ch))
            c = ch
        self.cnn.final = named_sequential(
            **{"0": nn.Conv2d(c, cc.embedding_dim, 1)})
        self.rndla = RandLANet(rl)
        ds_rgb = (64, 128, cc.psp_features, cc.psp_out)
        ds_pt = tuple(2 * d for d in rl.d_out)
        up_rgb = tuple(cc.up_channels[:2]) + (cc.embedding_dim,)
        up_pt = tuple(rl.decoder_widths[:3])
        for kind, rgb_w, pt_w in (("ds", ds_rgb, ds_pt),
                                  ("up", up_rgb, up_pt)):
            for name, c_in, c_out in (
                    ("r2p_pre", rgb_w, pt_w), ("r2p_fuse", pt_w, pt_w),
                    ("p2r_pre", pt_w, rgb_w), ("p2r_fuse", rgb_w, rgb_w)):
                fuse = name.endswith("fuse")
                self.add_module(f"{kind}_fuse_{name}_layers", nn.ModuleList([
                    ConvBNAct((2 if fuse else 1) * i, o, slope=slope)
                    for i, o in zip(c_in, c_out)]))
        width = cc.embedding_dim + rl.decoder_widths[-1]
        self.rgbd_seg_layer = PredictionHead(width, cfg.seg_head,
                                             cfg.n_classes)
        self.kp_ofst_layer = PredictionHead(width, cfg.kp_head,
                                            cfg.n_keypoints * 3)
        self.ctr_ofst_layer = PredictionHead(width, cfg.ctr_head, 3)
        self.eval()

    def uses_sparse_tail(self, batch: int) -> bool:
        """``PVN3D.uses_sparse_tail``'s rule for ``up_3`` + ``final``."""
        return not self.training and self.cfg.sparse_cnn_eval and batch == 1

    def frame_inputs(self, xyz: torch.Tensor, cloud_map: torch.Tensor
                     ) -> Dict:
        """The forward's input beyond PVN3D's, for the serving step
        (``inference.pipeline.make_raw_inference_step``, which keeps the
        sample in priority order for a model with this method) and the
        training step (``train/step.py``): ``index``, the neighbour index
        of the sampled points (B, N, 3) and the cloud map (B, H, W, 3),
        built on their device."""
        with annotate("pvn3d.neighbour_index"):
            return {"index": build_index(xyz, cloud_map, self.cfg)}

    # -- the image branch (NCHW) ---------------------------------------------
    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """``final`` on channels-last rows: the 1x1 conv, then the
        log-softmax over channels (float32), back in ``x.dtype``."""
        conv = self.cnn.final[0]
        y = linear(x, conv.weight, conv.bias)
        return F.log_softmax(y.float(), dim=-1).to(x.dtype)

    def image_stage(self, kind: str, i: int, x: torch.Tensor,
                    bn_momentum=0.1,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Encoder (``ds``) or decoder (``up``) image stage ``i``: NCHW in
        and out; on the card in eval mode with autograd off, a replayed
        CUDA graph a stage (``utils/graphs.py``)."""
        with annotate("pvn3d.image_branch"):
            return self.graphed((kind, i), lambda t: self._image_stage(
                kind, i, t, bn_momentum, generator), x)

    def _image_stage(self, kind: str, i: int, x: torch.Tensor,
                     bn_momentum=0.1,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        feats, cc = self.cnn.feats, self.cfg.cnn
        if kind == "ds":
            if i == 0:
                return feats.stage(1, feats.stem(x, bn_momentum),
                                   bn_momentum)
            if i == 1:
                return feats.stage(2, x, bn_momentum)
            if i == 2:
                return feats.stage(4, feats.stage(3, x, bn_momentum),
                                   bn_momentum)
            return dropout(self.cnn.psp(x), cc.dropout_psp, self.training,
                           generator)
        if i < 2:
            up = getattr(self.cnn, f"up_{i + 1}")
            if cc.fuse_upsample and not self.training:
                return up.fused(x, bn_momentum)
            return dropout(up(x, bn_momentum), cc.dropout_up, self.training,
                           generator)
        y = self._final(x.permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2)

    def image_last(self, x: torch.Tensor, choose: torch.Tensor,
                   batch: int, bn_momentum=0.1) -> torch.Tensor:
        """``up_3`` + ``final`` at the (B, N) chosen full-resolution
        pixels -> (B, N, C): sparse when a forward of ``batch`` frames
        takes the sparse tail, else the dense map gathered; a replayed
        graph as ``image_stage``."""
        sparse = self.uses_sparse_tail(batch)
        with annotate("pvn3d.image_branch"):
            return self.graphed(
                ("last", sparse),
                lambda t, c: self._image_last(t, c, sparse, bn_momentum),
                x, choose)

    def _image_last(self, x: torch.Tensor, choose: torch.Tensor,
                    sparse: bool, bn_momentum=0.1) -> torch.Tensor:
        b = x.shape[0]
        last = getattr(self.cnn, f"up_{len(self.cfg.cnn.up_channels)}")
        if sparse:
            out_w = 2 * x.shape[-1]
            choose = choose.int()
            return self._final(last.sparse(x, choose // out_w,
                                           choose % out_w, bn_momentum))
        y = self._final(last(x, bn_momentum).permute(0, 2, 3, 1))
        return gather_rows(y.reshape(b, -1, y.shape[-1]), choose)

    # -- the point branch (channels last) ------------------------------------
    def point_input(self, pointcloud: torch.Tensor, bn_momentum=0.1
                    ) -> torch.Tensor:
        with annotate("pvn3d.point_branch"):
            return self.rndla.fc0(pointcloud.to(self.dtype), bn_momentum)

    def point_encode(self, i: int, p: torch.Tensor, index: Dict,
                     bn_momentum=0.1):
        """RandLA block ``i`` on level ``i`` and the random sample to
        level ``i + 1``: (encoded, sampled)."""
        with annotate("pvn3d.point_branch"):
            enc = self.rndla.dilated_res_blocks[i](
                p, index["xyz"][i], index["nei"][i], bn_momentum)
            return enc, random_sample(enc, index["sub"][i])

    def point_decode(self, j: int, p: torch.Tensor, skip: torch.Tensor,
                     interp: torch.Tensor, bn_momentum=0.1) -> torch.Tensor:
        """Decoder conv ``j`` on [skip ; ``p`` at each finer point's
        nearest coarse point]."""
        with annotate("pvn3d.point_branch"):
            return self.rndla.decoder_blocks[j](torch.cat(
                [skip, nearest_interpolation(p, interp)], dim=-1),
                bn_momentum)

    # -- the fusion ------------------------------------------------------------
    def fuse(self, kind: str, i: int, rgb0: torch.Tensor, p0: torch.Tensor,
             p2r: torch.Tensor, r2p: torch.Tensor, bn_momentum=0.1):
        """Both directions after stage ``i``: the stage's NCHW map
        ``rgb0`` (B, C, h, w) and points ``p0`` (B, M, Cp), with each
        pixel's nearest point ``p2r`` (B, h*w) and each point's 16 nearest
        pixels ``r2p`` (B, M, 16) -> (the fused map, NCHW; the fused
        points)."""
        layers = {name: getattr(self, f"{kind}_fuse_{name}_layers")[i]
                  for name in ("r2p_pre", "r2p_fuse", "p2r_pre",
                               "p2r_fuse")}
        with annotate("pvn3d.fusion"):
            b, c, h, w = rgb0.shape
            rows = rgb0.permute(0, 2, 3, 1).reshape(b, h * w, c)
            fuse = layers["p2r_fuse"]
            pre = fuse.split(layers["p2r_pre"](p0, bn_momentum), c, 2 * c)
            y = fuse.finish(fuse.split(rows, 0, c) + gather_rows(pre, p2r),
                            bn_momentum)
            rgb = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
            pooled = layers["r2p_pre"](gather_rows(rows, r2p).amax(dim=2),
                                       bn_momentum)
            p = layers["r2p_fuse"](torch.cat([p0, pooled], dim=-1),
                                   bn_momentum)
        return rgb, p

    # -- heads -----------------------------------------------------------------
    def heads(self, rgb_emb: torch.Tensor, p: torch.Tensor,
              bn_momentum=0.1):
        with annotate("pvn3d.heads"):
            x = torch.cat([rgb_emb, p], dim=-1)
            return (self.rgbd_seg_layer(x, bn_momentum),
                    self.kp_ofst_layer(x, bn_momentum),
                    self.ctr_ofst_layer(x, bn_momentum))

    def forward(self, pointcloud: torch.Tensor, rgb: torch.Tensor,
                choose: torch.Tensor, index: Dict, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None,
                global_batch: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        m = bn_momentum
        b, n, _ = pointcloud.shape
        x = rgb.to(self.dtype).permute(0, 3, 1, 2)
        p = self.point_input(pointcloud, m)
        skips = []
        for i in range(len(cfg.ds_strides)):
            rgb0 = self.image_stage("ds", i, x, m, generator)
            enc, p0 = self.point_encode(i, p, index, m)
            if i == 0:
                skips.append(enc)
            x, p = self.fuse("ds", i, rgb0, p0, index["p2r_ds"][i],
                             index["r2p_ds"][i], m)
            skips.append(p)
        n_ds = len(cfg.ds_strides)
        for j in range(len(cfg.up_strides)):
            rgb0 = self.image_stage("up", j, x, m, generator)
            p0 = self.point_decode(j, p, skips[-j - 2],
                                   index["interp"][n_ds - j - 1], m)
            x, p = self.fuse("up", j, rgb0, p0, index["p2r_up"][j],
                             index["r2p_up"][j], m)
        rgb_emb = self.image_last(x, choose, global_batch or b, m)
        p = self.point_decode(len(cfg.up_strides), p, skips[0],
                              index["interp"][0], m)
        seg, kp, ctr = self.heads(rgb_emb, p, m)
        return {
            "seg_logits": seg.float(),
            "kp_offsets": kp.reshape(b, n, cfg.n_keypoints, 3)
            .permute(0, 2, 1, 3).float(),
            "ctr_offsets": ctr.reshape(b, n, 1, 3).permute(0, 2, 1, 3)
            .float(),
        }
