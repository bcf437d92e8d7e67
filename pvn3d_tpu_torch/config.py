"""Configuration tree of the PyTorch port: a copy of the JAX package's.

The dataclasses, defaults and ``Config.ycb()`` are field-for-field the JAX
package's (``tests/test_torch_weights.py::test_config_copy_matches`` holds
``dataclasses.asdict`` of both equal), so one config describes both.  The
eval restructures run as in the JAX package, each in eval mode only and
on by default: ``sparse_cnn_eval`` (the sparse CNN tail at batch 1,
``models/pvn3d.py``), ``fuse_upsample`` (``models/pspnet.py``),
``head_split_global`` and ``sa/fp_precompute_first``
(``models/pointnet2.py``); ``tests/test_torch_eval_graph.py`` holds each
against the JAX package's.  Knobs that only shape the TPU program
(``fps_mode``, ``resize_method``) are kept as fields and have no effect
here.  ``fusion_dim`` is documentation only: the fusion and the heads
take their widths from the two branches (``models/pvn3d.py``).

The neighbour and sampling modes run as in the JAX package, each through
its own kernel instance on the card (``ops/kernels/__init__.py`` names
them) and its plain version on the CPU, and each is held against the JAX
arm named here on the CPU (``tests/test_torch_modes.py``):

=========================  =================================  ==============
setting                    JAX arm (off a TPU)                port on the card
=========================  =================================  ==============
query_mode auto / exact    ball_query_multi(mode="exact"):    K2 exact
                           direct d^2, first ns hits
query_mode pallas          ball_query_pallas(capacity=        K2 capacity
                           query_capacity): expanded d^2, at
                           most C hits per residue class
                           (index % 128), then first ns;
                           query_compute ignored
query_mode approx          ball_query_multi(mode="approx"):   K2 expanded
                           expanded d^2, first ns (off a TPU
                           approx_min_k is exact, so
                           query_recall has no effect; the
                           TPU's recall-limited reduction has
                           no counterpart elsewhere)
query_compute bf16         coordinates rounded to bf16        K2 bf16
(exact / approx)           (nearest even), same f32 d^2
interp_mode auto / pallas  three_interpolate_fused: direct    K3 fused
                           d^2, (d^2, index) order
interp_mode exact /        three_nn + idw_weights +           K3 expanded
approx                     three_interpolate: expanded d^2,
                           lowest index on ties,
                           sqrt(max(d^2, 0))
fps_groups G > 1           _fps_grouped: stable sort on the   K1 on (B*G, N/G)
                           widest axis, G slabs, FPS of m/G   rows
                           each; slab_sorted after level 0;
                           fps_prefix only when G == 1
=========================  =================================  ==============

``query_mode`` is resolved per phase by
``models.pointnet2.resolve_query_mode`` with the backend "cuda", where
"auto" passes through to the exact query in training and evaluation.
``models.pvn3d.check_supported`` raises on an unknown mode or query dtype
and on a ``fps_groups`` that does not divide the point count and every
level's npoint.  The accuracy figures in the field comments below are the
JAX package's records on its synthetic world, not the port's
(``PERF.md`` section 6 has the port's).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Tuple

import numpy as np

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")

# ---------------------------------------------------------------------------
# Dataset metadata (reference: pvn3d/common.py:50-150 and dataset_config files)
# ---------------------------------------------------------------------------

YCB_CLASSES: Tuple[str, ...] = (
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

# Per-class bounding radii in meters (reference: datasets/ycb/dataset_config/
# radius.txt, loaded at common.py:80). Used for center-distance mask
# refinement during vote clustering (pvn3d_eval_utils.py:69).
YCB_RADII: Tuple[float, ...] = (
    0.070055, 0.1067245, 0.088012, 0.0509075, 0.095652, 0.042785,
    0.068953, 0.0505535, 0.051057, 0.089215, 0.121166, 0.125293,
    0.0806345, 0.0584515, 0.093733, 0.10295, 0.1007495, 0.060462,
    0.0855565, 0.104878, 0.0389385,
)

# Symmetric classes evaluated with ADD-S (reference: common.py:82).
YCB_SYM_CLS_IDS: Tuple[int, ...] = (13, 16, 19, 20, 21)

# LineMOD object name -> class id (reference: common.py:94-108).
LM_OBJ_DICT: Mapping[str, int] = {
    "ape": 1, "benchvise": 2, "cam": 4, "can": 5, "cat": 6, "driller": 8,
    "duck": 9, "eggbox": 10, "glue": 11, "holepuncher": 12, "iron": 13,
    "lamp": 14, "phone": 15,
}
LM_ID2OBJ: Mapping[int, str] = {v: k for k, v in LM_OBJ_DICT.items()}
LM_SYM_CLS_IDS: Tuple[int, ...] = (10, 11)

# Camera intrinsics (reference: common.py:137-150).
INTRINSICS: Mapping[str, np.ndarray] = {
    "linemod": np.array(
        [[572.4114, 0.0, 325.2611],
         [0.0, 573.57043, 242.04899],
         [0.0, 0.0, 1.0]], dtype=np.float32),
    "blender": np.array(
        [[700.0, 0.0, 320.0],
         [0.0, 700.0, 240.0],
         [0.0, 0.0, 1.0]], dtype=np.float32),
    "ycb_K1": np.array(
        [[1066.778, 0.0, 312.9869],
         [0.0, 1067.487, 241.3109],
         [0.0, 0.0, 1.0]], dtype=np.float32),
    "ycb_K2": np.array(
        [[1077.836, 0.0, 323.7872],
         [0.0, 1078.189, 279.6921],
         [0.0, 0.0, 1.0]], dtype=np.float32),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SALevelConfig:
    """One PointNet++ set-abstraction level with multi-scale grouping.

    Reference widths/radii: pvn3d/lib/pvn3d.py:67-112.
    """
    npoint: int
    radii: Tuple[float, ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]  # per-scale hidden widths (excl. input)


@dataclasses.dataclass(frozen=True)
class PointNet2Config:
    """PointNet++ MSG semantic-seg trunk (reference: pvn3d.py:46-154)."""
    input_channels: int = 6          # rgb + normal features per point
    use_xyz: bool = True
    # Neighbor-selection mode: "exact", "approx", "pallas" (the
    # residue-class ball query, ops/pallas/query.py of the JAX package;
    # K2's capacity instance here), or "auto".  In the JAX package "auto"
    # is TRAIN/EVAL-aware on TPU (approx while training, pallas at eval)
    # and exact elsewhere; on the port's CUDA backend it is exact
    # (resolve_query_mode).  JAX package's record (r4, synthetic e2e):
    # training through pallas's capacity-limited neighbor sets cost ~12
    # ADD-AUC, while at eval it was its best arm (33.8 vs exact 33.0 /
    # approx 32.6 on one checkpoint).
    query_mode: str = "auto"
    # FP-stage 3-NN interpolation, independent of the ball query: "auto"
    # and "pallas" run the fused exact 3-NN + IDW kernel (direct d^2; K3);
    # "exact"/"approx" the XLA three_nn formulation (expanded d^2; K3's
    # expanded instance here).  In the JAX package "auto" is the fused
    # kernel on TPU or under query_mode "pallas", XLA three_nn elsewhere.
    interp_mode: str = "auto"
    # Sharded FPS: sort by the widest axis, cut into G contiguous
    # equal-count slabs, run G parallel FPS chains of m/G steps each
    # (ops/sampling.py::_fps_grouped).  1 = reference-exact serial FPS.
    # G=4 cuts the serial chain of dependent steps 4x; covering radius
    # measured ~1.12x exact greedy (JAX package).
    # JAX package's accuracy record on its synthetic e2e world (600-step
    # training, benchmarks/synthetic_e2e.py): exact ADD-AUC 33.5 /
    # seg 0.854; trained+evaled with G=4: 24.7 / 0.757; weights trained
    # exact but evaled G=4: 19.1 / 0.686.  Latency-for-accuracy trade —
    # OFF by default; enable only where the deployment tolerates it.
    # Must divide every level's npoint and input size.
    fps_groups: int = 1
    # FPS kernel dispatch: "auto" = pallas on TPU / XLA scan elsewhere
    # (ops/sampling.py); "pallas"/"xla" force one arm (A/B runs, and
    # tracing the model for a non-TPU target from a TPU-backend process —
    # e.g. the live FLOP counter lowers on CPU, where pallas kernels
    # cannot lower outside interpret mode).
    fps_mode: str = "auto"
    # Nested-FPS prefix elision: greedy FPS is prefix-consistent — pick
    # k+1 maximizes min-dist over the whole set, hence over any subset
    # containing it, so FPS over a previous level's pick-ordered output
    # (seeded at its index 0, the previous seed) selects exactly rows
    # [0, npoint).  Levels 1..3 therefore slice instead of running their
    # serial chains: 3712 -> 2048 dependent steps (45% fewer) with
    # bit-identical selection (modulo float ties; the
    # mag<=1e-3 skip quirk is per-point and subset-independent, so it
    # preserves the property).  Exact mode only (fps_groups == 1).
    fps_prefix: bool = True
    # approx_min_k recall_target for approx-mode ball query (no effect
    # off a TPU, where approx_min_k is exact; the notes below are the JAX
    # package's TPU records).  The cost is
    # almost entirely the exact-aggregation phase over the reduction
    # buffer, whose width is recall-driven: at L0 (N=12288, k=32) 0.99
    # keeps 6144 candidates while 0.95 keeps 768 (8x fewer) and 0.98
    # keeps 1536.  MEASURED neighbor-set recall on the bench's
    # synthetic depth clouds: 0.9956/0.9945 (scales 1/2) at target 0.95
    # vs 0.9984/0.9994 at 0.99.  BUT e2e accuracy is sharply sensitive:
    # evaluating 0.99-trained weights at 0.95 dropped ADD-AUC 33.1 ->
    # 28.1 / seg 0.854 -> 0.829 on the synthetic e2e world — keep 0.99
    # unless weights were trained at the lower recall (see CLAUDE.md).
    query_recall: float = 0.99
    # Per-residue-class candidate capacity of the "pallas" ball query
    # (ops/pallas/query.py; K2's capacity instance here): a hit is kept
    # iff fewer than this many earlier hits share its index % 128, so the
    # result is the exact first-k whenever no class holds more than this
    # many of the first k hits.  JAX package's record on the realistic
    # plane+blobs scanline cloud (L0 shapes): capacity 2 -> neighbor-set
    # recall 0.9986/0.9998 (scales 1/2), >= the approx path at
    # recall_target 0.99; capacity 3 -> 0.9987/1.0.
    query_capacity: int = 2
    # Eval-only SA restructure: compute the first SharedMLP layer's
    # feature term per source point BEFORE the neighborhood gather
    # (models/pointnet2.py::SetAbstractionMSG.precompute_first).  Exact
    # up to one f32 add reassociation; equivalence-tested.
    sa_precompute_first: bool = True
    # Eval-only FP restructure: IDW interpolation commutes with the
    # pointwise first-layer matmul, so Dense_0 of each FP SharedMLP runs
    # on the m known rows before the 3-NN blend instead of the n
    # interpolated rows (6x fewer rows at the finest level), and the
    # blend moves widths[0] channels instead of C_known
    # (models/pointnet2.py::FeaturePropagation.precompute_first).  Exact
    # up to f32 reassociation; equivalence-tested.
    fp_precompute_first: bool = True
    # Distance-matrix dtype for ball query: "f32" (reference parity) or
    # "bf16" (halved MXU/HBM cost on a TPU; here the coordinates rounded
    # to bf16 before the same f32 arithmetic, ignored under "pallas").
    # JAX package's record on its synthetic e2e world with exact-trained
    # weights: eval under bf16 collapsed seg 0.854 -> 0.591
    # (radius-boundary membership churn at 8-bit mantissa) — keep f32 on
    # the accuracy path; bf16 only for throughput screening.
    query_compute: str = "f32"
    sa_levels: Tuple[SALevelConfig, ...] = (
        SALevelConfig(2048, (0.0175, 0.025), (16, 32),
                      ((16, 16, 32), (32, 32, 64))),
        SALevelConfig(1024, (0.025, 0.05), (16, 32),
                      ((64, 64, 128), (64, 96, 128))),
        SALevelConfig(512, (0.05, 0.1), (16, 32),
                      ((128, 196, 256), (128, 196, 256))),
        SALevelConfig(128, (0.1, 0.2), (16, 32),
                      ((256, 256, 512), (256, 384, 512))),
    )
    # Feature-propagation MLP widths, top (coarsest) to bottom
    # (reference: pvn3d.py:115-118, listed bottom-up there).
    fp_mlps: Tuple[Tuple[int, ...], ...] = (
        (128, 128), (256, 256), (512, 512), (512, 512),
    )


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Dilated-ResNet34 + PSP pyramid image branch.

    Reference: pvn3d/lib/pspnet.py:48-90 ('Modified_PSPNet', resnet34
    backend), pvn3d/lib/extractors.py:108-224 (output_stride 8 via dilation
    2/4 in layers 3/4).
    """
    backbone_layers: Tuple[int, ...] = (3, 4, 6, 3)   # resnet34
    psp_sizes: Tuple[int, ...] = (1, 2, 3, 6)
    psp_features: int = 512       # resnet34 trunk output channels
    psp_out: int = 1024
    up_channels: Tuple[int, ...] = (256, 64, 64)
    embedding_dim: int = 128      # per-pixel embedding fed to fusion
    dropout_psp: float = 0.3
    dropout_up: float = 0.15
    # Bilinear-resize realization in the PSP pyramid/upsample stages:
    # "matmul" (static-weight MXU matmuls), "lerp" (2-tap gather+lerp,
    # O(out) memory traffic) or "matmul_packed" (matmul with spatial
    # pairs packed into the 128-wide lane dim — the upsample stages run
    # at C=64, half a lane tile).  Bit-identical results
    # (models/layers.py::resize_bilinear); a perf A/B knob.
    resize_method: str = "matmul"
    # Eval-mode upsample restructure (models/pspnet.py::PSPUpsample.fused):
    # fold the 2x resize around the conv-tap matmul so the channel
    # contraction runs at low resolution (1/4 the conv FLOPs) and the
    # layout-bound full-res resize disappears.  Same parameters; equal to
    # the reference graph up to summation-order rounding.  Train mode
    # always uses the standard graph; the last (full-res) stage always
    # runs standard (measured slower fused, cnn_breakdown.py).
    fuse_upsample: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_classes: int = 22
    n_keypoints: int = 8
    n_sample_points: int = 12288   # reference: common.py:43
    cnn: CNNConfig = CNNConfig()
    pointnet2: PointNet2Config = PointNet2Config()
    fusion_dim: int = 1792         # 256 + 512 + 1024 (reference: pvn3d.py:182)
    seg_head: Tuple[int, ...] = (1024, 512, 128)
    kp_head: Tuple[int, ...] = (1024, 512, 256)
    ctr_head: Tuple[int, ...] = (1024, 512, 128)
    image_height: int = 480
    image_width: int = 640
    compute_dtype: str = "bfloat16"   # MXU-friendly; params stay f32
    # Evaluate the CNN tail (last PSP upsample + embedding head) only at
    # the N sampled pixels in eval mode.  Parameter-identical and
    # output-equivalent to dense-then-gather (tests/test_sparse_cnn.py).
    # Train mode always runs dense (batch stats over the full map).
    sparse_cnn_eval: bool = True
    # Eval-only: evaluate the three heads' first Dense on the split
    # fusion output — the 1024 global-context rows of each (1792, w)
    # kernel multiply one per-frame vector instead of N broadcast copies
    # (57% of the first-layer MACs; models/pvn3d.py::_SplitDense).
    # Bitwise-equivalent up to summation regrouping; equivalence-tested
    # incl. bf16 (tests/test_models.py).  Train keeps the literal concat.
    head_split_global: bool = True


# ---------------------------------------------------------------------------
# Training configuration (reference: common.py:36-47, train_ycb_pvn3d.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_total_epoch: int = 25
    mini_batch_size: int = 24
    num_mini_batch_per_epoch: int = 4000
    val_mini_batch_size: int = 24
    val_num_mini_batch_per_epoch: int = 125
    test_mini_batch_size: int = 1
    # CyclicLR triangular (reference: train_ycb_pvn3d.py:471-475,
    # warmup_scheduler/scheduler.py:255-263).
    base_lr: float = 1e-5
    max_lr: float = 1e-3
    lr_step_size: int = 25 * 4000 // 6
    weight_decay: float = 0.0
    # BN momentum schedule (reference: train_ycb_pvn3d.py:477-484):
    # bn_momentum(it) = max(0.9 * 0.5**(it*bs/decay_step), 1e-2)
    bn_momentum_init: float = 0.9
    bn_decay: float = 0.5
    bn_decay_step: float = 2e5
    bn_momentum_clip: float = 1e-2
    # Loss weights [seg, kp, ctr] (reference: train_ycb_pvn3d.py:182-184).
    loss_weights: Tuple[float, float, float] = (2.0, 1.0, 1.0)
    focal_gamma: float = 2.0
    seed: int = 0
    # Rematerialize the forward in backward (jax.checkpoint): trades
    # recompute for activation memory at large per-device batches.
    remat: bool = False
    # What the checkpointed forward is allowed to keep (jax.checkpoint
    # ``policy``).  "full" saves nothing (max recompute, min memory);
    # "dots" saves matmul/conv outputs and recomputes only the cheap
    # elementwise/BN/resize glue — for this conv-heavy model the backward
    # then re-runs almost no MXU work, trading a little memory back for
    # most of the recompute tax.  Values never change — remat is purely a
    # memory/compute schedule — so the choice is measured, not tested.
    remat_policy: str = "full"
    # Gradient accumulation: split the batch into this many equal
    # micro-batches inside ONE jitted step — micro grads are summed (each
    # micro loss scales its focal-seg term by 1/grad_accum; the reference
    # loss is inhomogeneous in batch size — seg is a point mean while the
    # offset terms sum over frames, train_ycb_pvn3d.py:176-181) and the
    # optimizer applies once, so the reference's bs-24 budget runs on
    # a single chip without remat's recompute tax or HBM spill.  BN
    # semantics match torch-style accumulation: each micro-batch
    # normalizes by its OWN statistics and the running stats update
    # sequentially (the reference's bs-24 BN sees the full batch — a
    # documented deviation of every accumulation scheme).  With identical
    # micro-batches the resulting params/opt_state are exactly the
    # full-batch step's (tests/test_train.py).
    grad_accum: int = 1


# ---------------------------------------------------------------------------
# Inference / clustering configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Batched MeanShift vote-clustering parameters.

    Reference: pvn3d_eval_utils.py:37-110 uses bandwidth 0.08 and sequential
    per-class per-keypoint fits; here all (class, keypoint+center) hypotheses
    run as one batched masked fixed-point iteration.
    """
    bandwidth: float = 0.08
    # Reference default (meanshift_pytorch.py:14); the fixed point
    # early-exits on convergence (max shift < bw*1e-3) so the cap is
    # rarely reached and costs nothing when unused.
    max_iter: int = 300
    # Per-class point cap for the K x K clustering problem.  The reference
    # clusters all class points (ragged); we pad/subsample to a fixed K.
    # Validated on the synthetic e2e world with one trained checkpoint
    # (benchmarks/synthetic_e2e.py --cluster_cap): ADD-AUC 33.5 @ 512,
    # 32.1 @ 1024, 32.0 @ 2048 — the ladder converges by 1024 and the
    # 512 deviation is small and non-directional; 12288 (all-points,
    # exact reference behavior) OOMs a single chip at batch 4 from the
    # O(K^2) seed-density stage.
    max_points_per_class: int = 512
    use_ctr: bool = True
    use_ctr_clus_filter: bool = True


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Batched point-to-point ICP refinement (reference: eval_icp.py)."""
    max_iter: int = 500
    tolerance: float = 1e-9
    max_mesh_points: int = 2000
    max_scene_points: int = 2000
    min_class_points: int = 1500
    cluster_bandwidth: float = 0.06


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "ycb"                 # "ycb" | "linemod"
    cls_type: str = ""                # linemod object name
    root: str = ""                    # dataset root on disk
    n_sample_points: int = 12288
    n_keypoints: int = 8
    n_min_points: int = 400
    # Max GT object instances per frame (YCB meta holds <=~10 objects).
    max_instances: int = 12

    @property
    def n_classes(self) -> int:
        return 22 if self.name == "ycb" else 2

    @property
    def n_objects(self) -> int:
        return self.n_classes


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = DatasetConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    cluster: ClusterConfig = ClusterConfig()
    icp: ICPConfig = ICPConfig()

    @staticmethod
    def ycb(**kw) -> "Config":
        return Config(dataset=DatasetConfig(name="ycb", **kw))

    @staticmethod
    def linemod(cls_type: str = "ape", **kw) -> "Config":
        return Config(
            dataset=DatasetConfig(name="linemod", cls_type=cls_type, **kw),
            model=ModelConfig(n_classes=2),
        )


def replace(cfg, **kw):
    """Functional update helper for any config dataclass."""
    return dataclasses.replace(cfg, **kw)


def small_model_config() -> ModelConfig:
    """A small model for checks away from the full size: 64x80 image,
    2048 points, SA npoints (512, 256, 128, 32) with radii grown so a
    cloud of ~0.3 m fills them, narrow heads, reference widths elsewhere,
    float32 compute."""
    levels = (
        SALevelConfig(512, (0.05, 0.1), (16, 32),
                      ((16, 16, 32), (32, 32, 64))),
        SALevelConfig(256, (0.1, 0.2), (16, 32),
                      ((64, 64, 128), (64, 96, 128))),
        SALevelConfig(128, (0.2, 0.3), (16, 32),
                      ((128, 196, 256), (128, 196, 256))),
        SALevelConfig(32, (0.3, 0.4), (16, 32),
                      ((256, 256, 512), (256, 384, 512))))
    return dataclasses.replace(
        ModelConfig(), compute_dtype="float32", image_height=64,
        image_width=80, n_sample_points=2048,
        pointnet2=PointNet2Config(sa_levels=levels),
        seg_head=(128, 64, 32), kp_head=(128, 64, 32),
        ctr_head=(128, 64, 32))
