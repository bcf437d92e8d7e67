"""The port's raw-frame serving path against the JAX package's: the
procedural sensor frame, the frame build on the device (depth fill,
normals, the priority subsample, feature assembly) with JAX's own
priorities, and ``make_raw_inference_step`` end to end on carried-across
weights.

As in ``tests/test_torch_slice.py``, JAX's winner pass is forced to its
Pallas kernel in interpret mode, so both sides decide MeanShift winners
with the same arithmetic.
"""
import ast
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data import device_frame as jax_frame
from pvn3d_tpu.inference.pipeline import (
    make_raw_inference_step as jax_make_raw_inference_step)
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.ops import preprocess as jax_pre

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.data.device_frame import (  # noqa: E402
    build_inference_batch_device, draw_priorities)
from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame  # noqa: E402
from pvn3d_tpu_torch.inference.pipeline import (  # noqa: E402
    make_raw_inference_step)
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa: E402
                                          stacked_mesh_kps)
from tests.test_torch_preprocess import (assert_normals_close,  # noqa: E402
                                         scene_depth)
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[572.4, 0, 80.0], [0, 573.5, 60.0], [0, 0, 1]], np.float32)


def jax_priorities(key, b, p):
    """The priorities JAX's batched frame build draws: one split key per
    frame, ``uniform(1e-4, 1)`` over the pixels."""
    return np.stack([np.asarray(jax.random.uniform(
        k, (p,), jnp.float32, 1e-4, 1.0)) for k in jax.random.split(key, b)])


def raw_frames(b=2, h=120, w=160, seed=0):
    rng = np.random.RandomState(seed)
    depth = np.stack([scene_depth(seed + i, h, w) for i in range(b)])
    rgb = (rng.rand(b, h, w, 3) * 255).astype(np.float32)
    ks = np.stack([K * np.float32([[1 + 0.05 * i], [1], [1]])
                   for i in range(b)])
    return rgb, depth, ks


def assert_frames_close(got, want, rgb, ks):
    """``choose`` identical, xyz within 1e-5, rgb exact, the filled depth
    within 1e-5, normals within 1e-4 but for flips decided by rounding
    (|n.p| < 1e-6, <= 0.1%).

    A normal is a difference quotient of the depth over ~2 pixels (a few
    mm), so the fill's 1e-5 tolerance allows normals a few 1e-3 apart on
    flat ground.  The normals are therefore held against JAX's normals of
    the port's own filled depth (which equals JAX's filled depth when no
    fill ran), each stage at its own tolerance.
    """
    choose = got["choose"].numpy()
    np.testing.assert_array_equal(choose, np.asarray(want["choose"]))
    assert got["choose"].dtype == torch.int32
    pc, wpc = got["pointcloud"].numpy(), np.asarray(want["pointcloud"])
    np.testing.assert_allclose(pc[..., :3], wpc[..., :3], atol=1e-5)
    np.testing.assert_array_equal(pc[..., 3:6], wpc[..., 3:6])
    depth_m = got["depth_m"].numpy()
    np.testing.assert_allclose(depth_m, np.asarray(want["depth_m"]),
                               atol=1e-5)
    b, h, w = rgb.shape[:3]
    rows = np.arange(b)[:, None]
    nrm = np.stack([np.asarray(jax_pre.normals_from_depth_map_jnp(
        jnp.asarray(d), jnp.asarray(k))) for d, k in zip(depth_m, ks)])
    assert_normals_close(pc[..., 6:], nrm.reshape(b, h * w, 3)[rows, choose],
                         pc[..., :3])
    np.testing.assert_array_equal(
        pc[..., 3:6], rgb.reshape(b, h * w, 3)[rows, choose])


def test_synth_sensor_frame_is_the_bench_frame():
    """The port's copy equals the JAX package's benchmark frame (its source
    is read and run, without importing the benchmark module, which sets up
    a compilation cache when imported)."""
    path = os.path.join(ROOT, "benchmarks", "raw_pipeline_bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "synth_sensor_frame")
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), path, "exec"), scope)
    for want, got in zip(scope["synth_sensor_frame"](48, 64, seed=3),
                         synth_sensor_frame(48, 64, seed=3)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fill", [True, False])
def test_build_batch_matches_jax(fill):
    rgb, depth, ks = raw_frames()
    key = jax.random.PRNGKey(5)
    want = jax_frame.build_inference_batch_device(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(ks), key,
        n_sample=2048, fill=fill)
    got = build_inference_batch_device(
        torch.tensor(rgb), torch.tensor(depth), torch.tensor(ks), 2048,
        fill=fill, priorities=torch.tensor(jax_priorities(key, 2, 120 * 160)))
    assert_frames_close(got, want, rgb, ks)
    if not fill:
        assert (got["pointcloud"][..., 2] > 1e-6).all()
        assert_normals_close(got["pointcloud"][..., 6:].numpy(),
                             np.asarray(want["pointcloud"])[..., 6:],
                             np.asarray(want["pointcloud"])[..., :3])


def test_build_native_units_matches_jax():
    """Depth in 0.1 mm units (``cam_scale`` 10000): filled in metres, the
    cloud and ``depth_m`` in metres."""
    rgb, depth, ks = raw_frames(b=1, seed=4)
    key = jax.random.PRNGKey(6)
    want = jax_frame.build_inference_batch_device(
        jnp.asarray(rgb), jnp.asarray(depth * 10000.0), jnp.asarray(ks), key,
        n_sample=1024, cam_scale=10000.0)
    got = build_inference_batch_device(
        torch.tensor(rgb), torch.tensor(depth * 10000.0), torch.tensor(ks),
        1024, cam_scale=10000.0,
        priorities=torch.tensor(jax_priorities(key, 1, 120 * 160)))
    assert_frames_close(got, want, rgb, ks)


@pytest.fixture
def jax_fixed_priorities(monkeypatch):
    """Make JAX's frame build draw the given priorities instead of its
    PRNG stream, so ties can be placed at the k-th score."""
    holder = {}

    def uniform(key, shape, dtype, minval, maxval):
        return jnp.asarray(holder["pri"], dtype).reshape(shape)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    jax.clear_caches()
    yield holder
    jax.clear_caches()


@pytest.mark.parametrize("case", ["ties_at_kth", "under_budget"])
def test_build_frame_selection_matches_jax(case, jax_fixed_priorities):
    """Equal priorities straddling the k-th score keep the lower pixel
    index (``lax.top_k``'s order); with fewer valid pixels than
    ``n_sample`` the rest repeat the first selected pixel."""
    rgb, depth, ks = raw_frames(b=1, h=60, w=80, seed=7)
    rng = np.random.RandomState(7)
    pri = (rng.randint(1, 9, 60 * 80) / 8.0).astype(np.float32)
    n_sample = 1000
    if case == "under_budget":
        depth[0, 20:] = 0.0                 # at most 20 x 10 = 200 valid
        depth[0, :, 10:] = 0.0
        n_sample = 256
    else:
        valid = np.flatnonzero(depth[0].ravel() > 1e-6)
        kth = np.sort(pri[valid])[::-1][n_sample - 1]
        assert (pri[valid] == kth).sum() > 100
    jax_fixed_priorities["pri"] = pri
    want = jax_frame.build_inference_frame_device(
        jnp.asarray(rgb[0]), jnp.asarray(depth[0]), jnp.asarray(ks[0]),
        jax.random.PRNGKey(0), n_sample=n_sample, fill=False)
    want = {k: np.asarray(v)[None] for k, v in want.items()}
    got = build_inference_batch_device(
        torch.tensor(rgb), torch.tensor(depth), torch.tensor(ks), n_sample,
        fill=False, priorities=torch.tensor(pri[None]))
    assert_frames_close(got, want, rgb, ks)
    choose = got["choose"].numpy()[0]
    if case == "under_budget":
        n_valid = int((depth > 1e-6).sum())
        assert 100 < n_valid < n_sample
        assert len(np.unique(choose)) == n_valid
        assert np.bincount(choose).max() == n_sample - n_valid + 1
        assert (np.diff(choose) >= 0).all()


def test_build_batched_equals_single():
    rgb, depth, ks = raw_frames(b=3, h=60, w=80, seed=8)
    pri = torch.tensor(jax_priorities(jax.random.PRNGKey(8), 3, 60 * 80))
    both = build_inference_batch_device(
        torch.tensor(rgb), torch.tensor(depth), torch.tensor(ks), 512,
        priorities=pri)
    for b in range(3):
        one = build_inference_batch_device(
            torch.tensor(rgb[b:b + 1]), torch.tensor(depth[b:b + 1]),
            torch.tensor(ks[b:b + 1]), 512, priorities=pri[b:b + 1])
        for k in ("pointcloud", "choose", "depth_m"):
            assert torch.equal(one[k][0], both[k][b]), k


def test_generator_draws_are_seeded_and_in_range():
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    a = draw_priorities((2, 5000), torch.device("cpu"), g[0])
    b = draw_priorities((2, 5000), torch.device("cpu"), g[1])
    assert torch.equal(a, b)
    assert a.min() >= 1e-4 and a.max() < 1.0
    rgb, depth, ks = raw_frames(b=1, h=60, w=80, seed=9)
    out = [build_inference_batch_device(
        torch.tensor(rgb), torch.tensor(depth), torch.tensor(ks), 512,
        generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(out[0]["choose"], out[1]["choose"])
    assert not torch.equal(out[0]["choose"], out[2]["choose"])


def _gt_and_meshes(rng, n_cls=22, m=300):
    mesh_pts = rng.uniform(-0.05, 0.05, (n_cls, m, 3)).astype(np.float32)
    mesh_valid = np.ones((n_cls, m), bool)
    mesh_valid[:, 200:] = rng.rand(n_cls, m - 200) < 0.5
    cls_ids = np.array([[1, 5, 0]], np.int32)
    rts = np.tile(np.eye(3, 4, dtype=np.float32), (1, 3, 1, 1))
    rts[..., 3] = rng.uniform(-0.3, 0.3, (1, 3, 3))
    rts[..., 2, 3] += 0.9
    return mesh_pts, mesh_valid, cls_ids, rts


def test_raw_step_matches_jax(jax_pallas_winner):
    """The raw path end to end, port (CPU) against JAX, same weights and
    priorities: frame build, forward, poses within 1e-4, and ADD / ADD-S
    against GT slots within 1e-5 m."""
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=21)
    cluster = dataclasses.replace(jax_config.ClusterConfig(),
                                  max_points_per_class=128)
    jcfg = jax_config.Config(model=cfg, cluster=cluster)
    h, w = cfg.image_height, cfg.image_width
    rgb, depth, k = synth_sensor_frame(h, w, seed=2)
    k = k.copy()
    k[:, 0, 2], k[:, 1, 2] = w / 2, h / 2
    k[:, :2, :2] *= 0.2
    mesh_pts, mesh_valid, cls_ids, rts = _gt_and_meshes(
        np.random.RandomState(21))
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    batch = {"rgb": rgb, "depth": depth, "cam_k": k, "cls_ids": cls_ids,
             "rts": rts}
    key = jax.random.PRNGKey(3)
    jstep = jax_make_raw_inference_step(
        jcfg, JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False), variables,
        mesh_kps, radii, mesh_pts, mesh_valid)
    want = jstep({kk: jnp.asarray(v) for kk, v in batch.items()}, key)

    model = PVN3D(to_port(cfg), sparse_cnn=False)
    model.load_state_dict(port_sd, strict=True)
    step = make_raw_inference_step(to_port(jcfg), model, mesh_kps, radii,
                                   mesh_pts, mesh_valid, device="cpu")
    got = step(batch, priorities=jax_priorities(key, 1, h * w))

    assert_frames_close(got, want, rgb, k)
    np.testing.assert_array_equal(got["seg"].numpy(), np.asarray(want["seg"]))
    present = got["present"].numpy()
    assert present.any()
    np.testing.assert_array_equal(present, np.asarray(want["present"]))
    np.testing.assert_allclose(got["poses"].numpy(),
                               np.asarray(want["poses"]), atol=1e-4)
    for kk in ("add", "adds"):
        assert got[kk].shape == (1, 3)
        np.testing.assert_allclose(got[kk].numpy(), np.asarray(want[kk]),
                                   atol=1e-5)
