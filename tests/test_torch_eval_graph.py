"""The port's eval graph against the JAX package's, restructure by
restructure and whole: the fused upsample stages, the sparse CNN tail
(border pixels included), the SA and FP precompute-first paths (FP
through K3's plain version, against JAX's ``_interp`` arms), the split
fusion with the split first head layer, and ``PVN3D(sparse_cnn=None)`` at
batch 1 (sparse tail) and batch 2 (dense tail), each in float32 and
bfloat16 on weights carried by ``from_jax_variables``.  Each restructure
is also held against the port's own dense graph, and train mode against
the graph with every restructure switched off.

Tolerances are the JAX package's own for its restructures
(``tests/test_sparse_cnn.py``, ``tests/test_models.py``): float32 1e-4 on
the model's outputs and 2e-5 on the sparse embedding, bfloat16 0.05 (bf16
rounding through the layers), each times max(1, |ref|): the fake
reference weights put some maps (the embedding, rgb_seg) in the hundreds.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.inference import meanshift as jax_meanshift
from pvn3d_tpu.inference import pipeline as jax_pipeline
from pvn3d_tpu.models.pointnet2 import (
    FeaturePropagation as JaxFP, SetAbstractionMSG as JaxSA)
from pvn3d_tpu.models.pspnet import PSPUpsample as JaxUpsample
from pvn3d_tpu.models.pvn3d import (
    DenseFusion as JaxFusion, PVN3D as JaxPVN3D,
    PredictionHead as JaxHead)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.inference.pipeline import make_inference_step  # noqa
from pvn3d_tpu_torch.models.layers import (  # noqa: E402
    shifted_resize_matrix, shifted_resize_tensor)
from pvn3d_tpu_torch.models.pointnet2 import FeaturePropagation  # noqa
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa
                                          stacked_mesh_kps)
from pvn3d_tpu_torch.utils.weights import from_jax_variables  # noqa
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

DTYPES = ("float32", "bfloat16")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RESTRUCTURES = dict(sa_precompute_first=False, fp_precompute_first=False)


def _close(got, ref, dtype, f32_tol, what=""):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = ((f32_tol if dtype == "float32" else 0.05)
           * max(1.0, float(np.abs(ref).max())))
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _frame(cfg, b, seed):
    """b seeded frames at the small model's size: a 0.3 m cloud 1 m off,
    point features, an image and distinct choose pixels."""
    rng = np.random.RandomState(seed)
    n, h, w = cfg.n_sample_points, cfg.image_height, cfg.image_width
    xyz = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * 0.3
    xyz[..., 2] += 1.0
    return [np.concatenate([xyz, rng.randn(b, n, 6).astype(np.float32)
                            * 0.5], -1),
            (rng.randn(b, h, w, 3) * 0.3).astype(np.float32),
            np.stack([rng.choice(h * w, size=n, replace=False)
                      for _ in range(b)]).astype(np.int32)]


@functools.lru_cache(maxsize=None)
def _sides(dtype):
    """The small model's JAX config and weights, and the port's model in
    eval mode on the same weights."""
    cfg = small_model_cfg(dtype)
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=12)
    model = PVN3D(to_port(cfg))
    model.load_state_dict(port_sd, strict=True)
    return cfg, variables, model


def _sub(variables, *path):
    """The ``{"params", "batch_stats"}`` subtree at ``path``."""
    out = {}
    for col in ("params", "batch_stats"):
        tree = variables[col]
        for key in path:
            tree = tree.get(key, {}) if isinstance(tree, dict) else {}
        if tree:
            out[col] = jax.tree_util.tree_map(jnp.asarray, tree)
    return out


def _tensor(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


# ------------------------------------------------------ fused upsample

def test_shifted_resize_matrix_is_the_jax_one():
    from pvn3d_tpu.models.layers import shifted_resize_matrix as jax_shifted
    for src, dst, ac in ((8, 16, True), (10, 20, True), (5, 12, False)):
        np.testing.assert_array_equal(shifted_resize_matrix(src, dst, ac),
                                      jax_shifted(src, dst, ac))
    a = shifted_resize_tensor(8, 16, True, torch.float32,
                              torch.device("cpu"))
    assert a is shifted_resize_tensor(8, 16, True, torch.float32,
                                      torch.device("cpu"))
    with torch.inference_mode():
        b = shifted_resize_tensor(9, 18, True, torch.float32,
                                  torch.device("cpu"))
    assert not b.is_inference()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", [1, 2])
def test_fused_upsample_matches_jax(dtype, stage):
    """``PSPUpsample.fused`` against JAX's on the stage's own weights, at
    the input the small model gives it (8x10 for up1, 16x20 for up2),
    and against the port's dense stage."""
    cfg, variables, model = _sides(dtype)
    up = getattr(model.cnn.model, f"up_{stage}")
    cin = up.conv[0].weight.shape[1]
    co = up.conv[0].weight.shape[0]
    h, w = 8 * 2 ** (stage - 1), 10 * 2 ** (stage - 1)
    x = np.random.RandomState(stage).randn(2, h, w, cin).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmod = JaxUpsample(features=co, train=False, dtype=jdt)
    want = jmod.apply(_sub(variables, "cnn", f"up{stage}"),
                      jnp.asarray(x, jdt), method=JaxUpsample.fused)
    xt = _tensor(x, TORCH_DTYPE[dtype]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = up.fused(xt).permute(0, 2, 3, 1)
        dense = up(xt).permute(0, 2, 3, 1)
    _close(got, want, dtype, 1e-5, "fused vs JAX fused")
    _close(got, np.asarray(dense.float()), dtype, 1e-5, "fused vs dense")


# --------------------------------------------------------- sparse tail

def _border_pixels(rng, oh, ow, p):
    """``p`` output pixels: every corner and border midpoint of the
    (oh, ow) map, its rows and columns 0, 1, oh-2/ow-2 and oh-1/ow-1,
    then random ones."""
    edge_r = [0, 1, oh // 2, oh - 2, oh - 1]
    edge_c = [0, 1, ow // 2, ow - 2, ow - 1]
    pix = [r * ow + c for r in edge_r for c in edge_c]
    pix += list(rng.randint(0, oh * ow, p - len(pix)))
    return np.asarray(pix, np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_tail_matches_jax(dtype):
    """``PSPUpsample.sparse`` on the last stage at border and random
    pixels against JAX's, and against the port's dense stage gathered at
    the same pixels (2e-5 in float32)."""
    cfg, variables, model = _sides(dtype)
    up = model.cnn.model.up_3
    cin = up.conv[0].weight.shape[1]
    co = up.conv[0].weight.shape[0]
    h, w = 32, 40
    rng = np.random.RandomState(5)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    choose = np.stack([_border_pixels(rng, 2 * h, 2 * w, 300)
                       for _ in range(2)])
    rows, cols = choose // (2 * w), choose % (2 * w)
    jdt = jnp.dtype(dtype)
    want = JaxUpsample(features=co, train=False, dtype=jdt).apply(
        _sub(variables, "cnn", "up3"), jnp.asarray(x, jdt),
        jnp.asarray(rows), jnp.asarray(cols), method=JaxUpsample.sparse)
    xt = _tensor(x, TORCH_DTYPE[dtype]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = up.sparse(xt, torch.tensor(rows), torch.tensor(cols))
        dense = up(xt).permute(0, 2, 3, 1).reshape(2, -1, co)
    _close(got, want, dtype, 2e-5, "sparse vs JAX sparse")
    gathered = np.take_along_axis(dense.float().numpy(), choose[..., None],
                                  axis=1)
    _close(got, gathered, dtype, 2e-5, "sparse vs dense gathered")


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_embedding_matches_dense_gather(dtype):
    """The image branch with ``choose``: the embedding and the seg
    log-probs at the chosen pixels equal the dense maps gathered there
    (2e-5 in float32), and rgb_seg comes as (B, P, n_classes)."""
    cfg, _, model = _sides(dtype)
    pc, rgb, choose = _frame(cfg, 2, seed=8)
    cnn = model.cnn.model
    dt = TORCH_DTYPE[dtype]
    with torch.inference_mode():
        emb_s, seg_s = cnn(_tensor(rgb, dt), choose=torch.tensor(choose))
        emb_d, seg_d = cnn(_tensor(rgb, dt))
    assert seg_s.shape == (2, cfg.n_sample_points, cfg.n_classes)
    idx = choose[..., None]
    for s, d, what in ((emb_s, emb_d, "embedding"), (seg_s, seg_d, "seg")):
        d = d.float().numpy().reshape(2, -1, d.shape[-1])
        _close(s, np.take_along_axis(d, idx, axis=1), dtype, 2e-5, what)


# ---------------------------------------------------- point branch

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", [0, 1])
def test_sa_precompute_matches_jax(dtype, level):
    """SA with ``sa_precompute_first`` (gather after the layer-0 feature
    product) against JAX's, and against the port's literal SA."""
    cfg, variables, model = _sides(dtype)
    pcfg = cfg.pointnet2
    sa = model.pointnet2.SA_modules[level]
    c_in = sa.mlps[0].layer0.conv.weight.shape[1] - 3
    rng = np.random.RandomState(20 + level)
    n = cfg.n_sample_points if level == 0 else pcfg.sa_levels[0].npoint
    xyz = ((rng.rand(1, n, 3) - 0.5) * 0.3).astype(np.float32)
    feats = rng.randn(1, n, c_in).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmod = JaxSA(level=pcfg.sa_levels[level], train=False, dtype=jdt,
                 query_mode=pcfg.query_mode, fps_prefix=level > 0)
    _, want = jmod.apply(_sub(variables, "pointnet2", f"sa{level}"),
                         jnp.asarray(xyz), jnp.asarray(feats, jdt))
    dt = TORCH_DTYPE[dtype]
    with torch.inference_mode():
        _, got = sa(torch.tensor(xyz), _tensor(feats, dt), dt)
        sa.precompute_first = False
        _, literal = sa(torch.tensor(xyz), _tensor(feats, dt), dt)
        sa.precompute_first = True
    _close(got, want, dtype, 1e-4, "SA precompute vs JAX")
    _close(got, np.asarray(literal.float()), dtype, 1e-4,
           "SA precompute vs literal")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interp_mode", ["pallas", "exact"])
@pytest.mark.parametrize("level", [0, 2, 3])
def test_fp_precompute_matches_jax(dtype, interp_mode, level):
    """FP with ``fp_precompute_first`` (the layer-0 product on the known
    rows, blended by K3's plain version in float32) against JAX's, whose
    ``_interp`` takes the fused Pallas kernel (interpret mode) for
    "pallas" and ``three_nn`` + ``three_interpolate`` for "exact"; and
    against the port's literal FP."""
    cfg, variables, model = _sides(dtype)
    pcfg = cfg.pointnet2
    src = model.pointnet2.FP_modules[level]
    c_in = src.mlp.layer0.conv.weight.shape[1]
    fp = FeaturePropagation(c_in, pcfg.fp_mlps[level], interp_mode)
    fp.load_state_dict(src.state_dict())
    fp.eval()
    sizes = [cfg.n_sample_points] + [lv.npoint for lv in pcfg.sa_levels]
    skip = (6 if level == 0 else
            sum(m[-1] for m in pcfg.sa_levels[level - 1].mlps))
    c_known = c_in - skip
    rng = np.random.RandomState(30 + level)
    xyz = ((rng.rand(1, sizes[level], 3) - 0.5) * 0.3).astype(np.float32)
    known_xyz = xyz[:, :sizes[level + 1]].copy()
    unknown_feats = rng.randn(1, sizes[level], skip).astype(np.float32)
    known_feats = rng.randn(1, sizes[level + 1], c_known).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmod = JaxFP(widths=pcfg.fp_mlps[level], train=False, dtype=jdt,
                 query_mode=pcfg.query_mode, interp_mode=interp_mode)
    want = jmod.apply(_sub(variables, "pointnet2", f"fp{level}"),
                      jnp.asarray(xyz), jnp.asarray(known_xyz),
                      jnp.asarray(unknown_feats, jdt),
                      jnp.asarray(known_feats, jdt))
    dt = TORCH_DTYPE[dtype]
    args = (torch.tensor(xyz), torch.tensor(known_xyz),
            _tensor(unknown_feats, dt), _tensor(known_feats, dt), dt)
    with torch.inference_mode():
        got = fp(*args)
        fp.precompute_first = False
        literal = fp(*args)
    _close(got, want, dtype, 1e-4, "FP precompute vs JAX")
    _close(got, np.asarray(literal.float()), dtype, 1e-4,
           "FP precompute vs literal")


# ------------------------------------------------ split fusion + heads

@pytest.mark.parametrize("dtype", DTYPES)
def test_split_fusion_and_heads_match_jax(dtype):
    """``DenseFusion(split_global)`` into each head's split first layer
    against JAX's ``_SplitDense`` heads, and against the port's literal
    concat."""
    cfg, variables, model = _sides(dtype)
    rng = np.random.RandomState(40)
    n = 700
    rgb_emb = rng.randn(2, n, cfg.cnn.embedding_dim).astype(np.float32)
    cld_emb = rng.randn(2, n, cfg.pointnet2.fp_mlps[0][-1]).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    jfused = JaxFusion(train=False, dtype=jdt, split_global=True).apply(
        _sub(variables, "fusion"), jnp.asarray(rgb_emb, jdt),
        jnp.asarray(cld_emb, jdt))
    dt = TORCH_DTYPE[dtype]
    args = (_tensor(rgb_emb, dt), _tensor(cld_emb, dt))
    with torch.inference_mode():
        split = model.rgbd_feat(*args, split_global=True)
        literal = model.rgbd_feat(*args)
    _close(split[0], jfused[0], dtype, 1e-5, "fusion local")
    _close(split[1], jfused[1], dtype, 1e-5, "fusion global")
    for port_name, name, widths, out_dim in (
            ("SEG_layer", "seg_head", cfg.seg_head, cfg.n_classes),
            ("KpOF_layer", "kp_head", cfg.kp_head, cfg.n_keypoints * 3),
            ("CtrOf_layer", "ctr_head", cfg.ctr_head, 3)):
        want = JaxHead(widths, out_dim, train=False, dtype=jdt).apply(
            _sub(variables, name), jfused)
        head = getattr(model, port_name)
        with torch.inference_mode():
            got = head(split)
            dense = head(literal)
        _close(got, want, dtype, 1e-4, f"{name} split vs JAX")
        _close(got, np.asarray(dense.float()), dtype, 1e-4,
               f"{name} split vs literal")


# ------------------------------------------------------- whole model

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,forced", [(1, None), (2, None), (1, False),
                                          (2, True)])
def test_pvn3d_matches_jax_eval_graph(dtype, batch, forced):
    """``PVN3D(sparse_cnn=forced)`` in eval mode against JAX's: at batch 1
    the auto rule takes the sparse tail (rgb_seg (1, N, n_classes)), at
    batch 2 the dense one (rgb_seg (2, H, W, n_classes)), the other
    restructures on in both; True / False force the tail as JAX's do."""
    cfg, variables, model = _sides(dtype)
    frame = _frame(cfg, batch, seed=50 + batch)
    want = jax.jit(JaxPVN3D(cfg=cfg, train=False, sparse_cnn=forced).apply)(
        variables, *(jnp.asarray(x) for x in frame))
    model.sparse_cnn = forced
    try:
        with torch.inference_mode():
            got = model(*(torch.tensor(x) for x in frame))
    finally:
        model.sparse_cnn = None
    sparse = forced if forced is not None else batch == 1
    n, h, w = cfg.n_sample_points, cfg.image_height, cfg.image_width
    assert got["rgb_seg"].shape == ((batch, n, cfg.n_classes) if sparse
                                    else (batch, h, w, cfg.n_classes))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        _close(got[k], want[k], dtype, 1e-4, k)
    _close(got["rgb_seg"], want["rgb_seg"], dtype, 2e-5, "rgb_seg")
    # bf16 seg logits of these weights lie within rounding of each other
    # on ~12% of the points (top-2 margin < 0.01), where any two bf16
    # graphs may pick different classes: JAX's own restructured and
    # literal bf16 graphs agree on 97.8% (batch 1) / 98.3% (batch 2) of
    # them, the port's auto graph and JAX's on 97.3% / 97.6%.
    agree = (got["seg_logits"].numpy().argmax(-1)
             == np.asarray(want["seg_logits"]).argmax(-1)).mean()
    assert agree > (0.999 if dtype == "float32" else 0.95)


def test_auto_graph_matches_the_dense_graph():
    """The port's auto graph at batch 1 against its own graph with every
    restructure off (sparse_cnn False, fuse_upsample, head_split_global
    and the SA/FP precompute off): float32 1e-4."""
    cfg, variables, model = _sides("float32")
    frame = [torch.tensor(x) for x in _frame(cfg, 1, seed=60)]
    plain_cfg = to_port(dataclasses.replace(
        cfg, head_split_global=False,
        cnn=dataclasses.replace(cfg.cnn, fuse_upsample=False),
        pointnet2=dataclasses.replace(cfg.pointnet2, **RESTRUCTURES)))
    plain = PVN3D(plain_cfg, sparse_cnn=False)
    plain.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        got, want = model(*frame), plain(*frame)
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        err = (got[k] - want[k]).abs().max().item()
        assert err < 1e-4, f"{k}: {err}"


def test_one_jax_tree_loads_into_both_graphs():
    """``from_jax_variables`` yields exactly the state_dict keys of the
    sparse and the dense graph: the restructures add no parameter."""
    cfg, variables, _ = _sides("float32")
    sd = from_jax_variables(variables)
    for forced in (True, False, None):
        m = PVN3D(to_port(cfg), sparse_cnn=forced)
        assert set(m.state_dict()) == set(sd)
        m.load_state_dict(sd, strict=True)


def test_train_mode_forward_is_the_literal_graph():
    """Train mode takes none of the restructures: at batch 1 its forward
    (batch statistics, dropouts from one seed) equals, bit for bit, the
    forward of the model with every restructure switched off, and its
    rgb_seg is the dense map."""
    cfg, _, model = _sides("float32")
    plain_cfg = to_port(dataclasses.replace(
        cfg, sparse_cnn_eval=False, head_split_global=False,
        cnn=dataclasses.replace(cfg.cnn, fuse_upsample=False),
        pointnet2=dataclasses.replace(cfg.pointnet2, **RESTRUCTURES)))
    plain = PVN3D(plain_cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    plain.load_state_dict(sd, strict=True)
    fresh = PVN3D(to_port(cfg))
    fresh.load_state_dict(sd, strict=True)
    frame = [torch.tensor(x) for x in _frame(cfg, 1, seed=70)]
    outs = []
    for m in (fresh.train(), plain.train()):
        with torch.no_grad():
            outs.append(m(*frame, bn_momentum=0.1,
                          generator=torch.Generator().manual_seed(3)))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets", "rgb_seg"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert outs[0]["rgb_seg"].shape[1:3] == (cfg.image_height,
                                             cfg.image_width)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, plain.state_dict()[k]), k


# ------------------------------------------------------- serving step

@pytest.fixture
def jax_pallas_winner(monkeypatch):
    monkeypatch.setattr(jax_meanshift, "_winner_stats", functools.partial(
        jax_meanshift._winner_stats, impl="pallas"))
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_inference_step_batch1_matches_jax(jax_pallas_winner):
    """``make_inference_step`` at batch 1, where both packages take the
    sparse tail and every restructure, against JAX's step on the same
    weights (its winner arm at its Pallas kernel, interpret mode, as
    ``tests/test_torch_slice.py`` does): seg and present equal, poses and
    keypoints within 1e-4."""
    cfg, variables, model = _sides("float32")
    cluster = dataclasses.replace(jax_config.ClusterConfig(),
                                  max_points_per_class=128)
    jcfg = jax_config.Config(model=cfg, cluster=cluster)
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    pc, rgb, choose = _frame(cfg, 1, seed=12)
    batch = {"pointcloud": pc, "rgb": rgb, "choose": choose}
    jstep = jax_pipeline.make_inference_step(
        jcfg, JaxPVN3D(cfg=cfg, train=False), variables, mesh_kps, radii)
    want = jstep({k: jnp.asarray(v) for k, v in batch.items()})
    step = make_inference_step(to_port(jcfg), model, mesh_kps, radii,
                               device="cpu")
    got = step(batch)
    assert got["present"].numpy().any()
    np.testing.assert_array_equal(got["seg"].numpy(),
                                  np.asarray(want["seg"]))
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(want["present"]))
    np.testing.assert_allclose(got["poses"].numpy(),
                               np.asarray(want["poses"]), atol=1e-4)
    np.testing.assert_allclose(got["kps"].numpy(), np.asarray(want["kps"]),
                               atol=1e-4)
