"""The port's modules against the JAX package's on the same weights (a
random reference checkpoint through ``convert_pvn3d`` for JAX and
``from_jax_variables`` for the port) and the same seeded inputs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.models import layers as jax_layers
from pvn3d_tpu.models.layers import SharedMLP as JaxSharedMLP
from pvn3d_tpu.models.pointnet2 import PointNet2MSG as JaxPointNet2MSG
from pvn3d_tpu.models.pspnet import PSPNetEmbedding as JaxPSPNetEmbedding

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.models import layers  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)


@pytest.fixture(scope="module")
def models():
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=2)
    model = PVN3D(to_port(cfg))
    model.load_state_dict(port_sd, strict=True)
    return cfg, variables, model


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


def _cloud(rng, n):
    xyz = (rng.rand(1, n, 3).astype(np.float32) - 0.5) * 0.3
    return np.concatenate([xyz, rng.randn(1, n, 6).astype(np.float32) * 0.5],
                          -1)


@pytest.mark.parametrize("level,scale", [(0, 0), (2, 1)])
def test_shared_mlp_matches(models, level, scale):
    cfg, variables, model = models
    widths = cfg.pointnet2.sa_levels[level].mlps[scale]
    mlp = model.pointnet2.SA_modules[level].mlps[scale]
    c_in = mlp.layer0.conv.weight.shape[1]
    x = np.random.RandomState(level).randn(1, 64, 16, c_in).astype(
        np.float32)
    want = JaxSharedMLP(widths, train=False).apply(
        _sub(variables, "pointnet2", f"sa{level}", f"mlp{scale}"),
        jnp.asarray(x))
    with torch.inference_mode():
        got = mlp(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_shared_mlp_bfloat16(models):
    """bf16 compute with float32 weights and BN statistics, as JAX does;
    held to bf16 rounding (2^-8 relative per layer, three layers)."""
    cfg, variables, model = models
    widths = cfg.pointnet2.sa_levels[1].mlps[0]
    mlp = model.pointnet2.SA_modules[1].mlps[0]
    c_in = mlp.layer0.conv.weight.shape[1]
    x = np.random.RandomState(7).randn(1, 32, 16, c_in).astype(np.float32)
    want = JaxSharedMLP(widths, train=False, dtype=jnp.bfloat16).apply(
        _sub(variables, "pointnet2", "sa1", "mlp0"),
        jnp.asarray(x, jnp.bfloat16))
    with torch.inference_mode():
        got = mlp(torch.tensor(x, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=3e-2 * np.abs(want).max())


def test_psp_embedding_matches(models):
    cfg, variables, model = models
    cc = cfg.cnn
    rgb = (np.random.RandomState(3).randn(1, cfg.image_height,
                                          cfg.image_width, 3) * 0.3
           ).astype(np.float32)
    jax_mod = JaxPSPNetEmbedding(
        n_classes=cfg.n_classes, sizes=cc.psp_sizes, psp_out=cc.psp_out,
        up_channels=cc.up_channels, embedding_dim=cc.embedding_dim,
        backbone_layers=cc.backbone_layers, train=False)
    want_emb, want_seg = jax.jit(jax_mod.apply)(_sub(variables, "cnn"),
                                                jnp.asarray(rgb))
    with torch.inference_mode():
        emb, seg = model.cnn.model(torch.tensor(rgb))
    # 1e-4 of the map's scale: the random checkpoint drives embeddings to
    # ~1e2, and ~40 float32 convs in another summation order than XLA's
    # leave ~1e-5 relative.
    want_emb = np.asarray(want_emb)
    np.testing.assert_allclose(emb.numpy(), want_emb,
                               atol=1e-4 * np.abs(want_emb).max())
    want_seg = np.asarray(want_seg)
    np.testing.assert_allclose(seg.numpy(), want_seg,
                               atol=1e-4 * np.abs(want_seg).max())


def test_pointnet2_matches(models):
    cfg, variables, model = models
    pcld = _cloud(np.random.RandomState(4), cfg.n_sample_points)
    want = jax.jit(JaxPointNet2MSG(cfg=cfg.pointnet2, train=False).apply)(
        _sub(variables, "pointnet2"), jnp.asarray(pcld))
    with torch.inference_mode():
        got = model.pointnet2(torch.tensor(pcld)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_resize_and_pool_match():
    x = np.random.RandomState(5).randn(2, 7, 9, 4).astype(np.float32)
    for args in ((14, 18, True), (5, 6, False), (16, 20, False)):
        want = jax_layers.resize_bilinear(jnp.asarray(x), *args)
        got = layers.resize_bilinear(torch.tensor(x), *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        nchw = layers.resize_bilinear(torch.tensor(x).permute(0, 3, 1, 2),
                                      *args, channels_last=False)
        np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-6)
    for s in (1, 2, 3, 6):
        want = jax_layers.adaptive_avg_pool(jnp.asarray(x), s, s)
        got = layers.adaptive_avg_pool(torch.tensor(x), s, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jax_layers.max_pool_3x3_s2(jnp.asarray(x))
    got = layers.max_pool_3x3_s2(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_unsupported_settings_raise():
    import dataclasses
    cfg = to_port(small_model_cfg())
    for bad in (dataclasses.replace(cfg, compute_dtype="float16"),
                dataclasses.replace(cfg, pointnet2=dataclasses.replace(
                    cfg.pointnet2, fps_groups=3))):
        with pytest.raises((ValueError, NotImplementedError)):
            PVN3D(bad)
