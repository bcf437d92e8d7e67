"""The port's serving slice against the JAX package's: the full PVN3D
forward on carried-across weights, votes to poses on the same votes, and
``make_inference_step`` against JAX's forward + ``make_pose_fn``.

The JAX pose path runs its MeanShift winner pass in XLA's expanded-d^2
form off TPU, whose cancellation can flip a pair within f32 rounding of
the bandwidth; the port's kernel and plain version use the direct form.
These tests force JAX's winner arm to its Pallas kernel in interpret mode
(direct form, ``impl="pallas"``), so both sides decide winners with the
same arithmetic.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.inference import meanshift as jax_meanshift
from pvn3d_tpu.inference.pipeline import make_pose_fn as jax_make_pose_fn
from pvn3d_tpu.inference.pose import cal_frame_poses as jax_cal_frame_poses
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.inference.pipeline import (  # noqa: E402
    make_inference_step, make_pose_fn)
from pvn3d_tpu_torch.inference.meanshift import mean_shift_fit  # noqa: E402
from pvn3d_tpu_torch.inference.pose import cal_frame_poses  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa: E402
                                          stacked_mesh_kps)
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

N_CLS = 22


@pytest.fixture
def jax_pallas_winner(monkeypatch):
    monkeypatch.setattr(jax_meanshift, "_winner_stats", functools.partial(
        jax_meanshift._winner_stats, impl="pallas"))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def forward():
    """One seeded frame through the JAX dense reference graph and the
    port on the same weights."""
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=12)
    rng = np.random.RandomState(12)
    n, h, w = cfg.n_sample_points, cfg.image_height, cfg.image_width
    xyz = (rng.rand(1, n, 3).astype(np.float32) - 0.5) * 0.3
    xyz[..., 2] += 1.0
    batch = {
        "pointcloud": np.concatenate(
            [xyz, rng.randn(1, n, 6).astype(np.float32) * 0.5], -1),
        "rgb": (rng.randn(1, h, w, 3) * 0.3).astype(np.float32),
        "choose": rng.choice(h * w, size=(1, n), replace=False).astype(
            np.int32),
    }
    apply = jax.jit(JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False).apply)
    out = apply(variables, *(jnp.asarray(batch[k])
                             for k in ("pointcloud", "rgb", "choose")))
    model = PVN3D(to_port(cfg))
    model.load_state_dict(port_sd, strict=True)
    return cfg, batch, {k: np.asarray(v) for k, v in out.items()}, model


def test_pvn3d_forward_matches(forward):
    _, batch, want, model = forward
    with torch.inference_mode():
        got = model(*(torch.tensor(batch[k])
                      for k in ("pointcloud", "rgb", "choose")))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        assert got[k].shape == want[k].shape
        err = np.abs(got[k].numpy() - want[k]).max()
        assert err < 2e-3, f"{k}: max abs err {err}"
    agree = (got["seg_logits"].numpy().argmax(-1)
             == want["seg_logits"].argmax(-1)).mean()
    assert agree > 0.999


def test_inference_step_matches_jax(forward, jax_pallas_winner):
    """The slice end to end: the port's make_inference_step on the CPU
    against JAX's forward + make_pose_fn: poses within 1e-4, present
    equal."""
    cfg, batch, want, model = forward
    cluster = dataclasses.replace(jax_config.ClusterConfig(),
                                  max_points_per_class=128)
    jcfg = jax_config.Config(model=cfg, cluster=cluster)
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    seg = want["seg_logits"].argmax(-1).astype(np.int32)
    jframe = jax_make_pose_fn(jcfg, mesh_kps, radii)(
        jnp.asarray(batch["pointcloud"][..., :3]), jnp.asarray(seg),
        jnp.asarray(want["ctr_offsets"]), jnp.asarray(want["kp_offsets"]))
    step = make_inference_step(to_port(jcfg), model, mesh_kps, radii,
                               device="cpu")
    got = step(batch)
    assert got["present"].numpy().any()
    np.testing.assert_array_equal(got["seg"].numpy(), seg)
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(jframe.present))
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(jframe.poses),
                               atol=1e-4)
    np.testing.assert_allclose(got["kps"].numpy(), np.asarray(jframe.kps),
                               atol=1e-4)


def _votes(seed, n=1024, n_obj=4):
    """Class clusters, their center / keypoint votes with noise, a class
    the mask never predicts, and background points."""
    rng = np.random.RandomState(seed)
    kps = stacked_mesh_kps()
    pcld = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pcld[:, 2] += 1.0
    mask = np.zeros(n, np.int32)
    ctr_of = np.zeros((1, n, 3), np.float32)
    kp_of = np.zeros((8, n, 3), np.float32)
    per = n // (n_obj + 1)
    for o in range(n_obj):
        cls = 2 * o + 1
        sl = slice(o * per, (o + 1) * per)
        center = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        center[2] += 1.0
        pcld[sl] = center + rng.normal(0, 0.04, (per, 3))
        mask[sl] = cls
        ctr_of[0, sl] = pcld[sl] - center - rng.normal(0, 0.01, (per, 3))
        kp_cam = center + kps[cls, :8] * 2.0
        kp_of[:, sl] = (pcld[None, sl] - kp_cam[:, None]
                        - rng.normal(0, 0.01, (8, per, 3)))
    return pcld, mask, ctr_of, kp_of


@pytest.mark.parametrize("seed", [0, 1])
def test_cal_frame_poses_matches(seed, jax_pallas_winner):
    pcld, mask, ctr_of, kp_of = _votes(seed)
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    kw = dict(n_cls=N_CLS, n_kps=8, k=128, bandwidth=0.08, max_iter=300)
    want = jax_cal_frame_poses(
        jnp.asarray(pcld), jnp.asarray(mask), jnp.asarray(ctr_of),
        jnp.asarray(kp_of), jnp.asarray(mesh_kps), jnp.asarray(radii), **kw)
    got = cal_frame_poses(
        torch.tensor(pcld), torch.tensor(mask), torch.tensor(ctr_of),
        torch.tensor(kp_of), torch.tensor(mesh_kps), torch.tensor(radii),
        **kw)
    np.testing.assert_array_equal(got.present.numpy(),
                                  np.asarray(want.present))
    assert got.present.numpy().sum() == 4
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=1e-4)
    # Absent classes keep the zero pose.
    assert (got.poses.numpy()[~got.present.numpy()] == 0).all()


def test_pose_fn_batches_frames():
    pcld, mask, ctr_of, kp_of = _votes(3)
    fn = make_pose_fn(port_config.Config.ycb(), stacked_mesh_kps(),
                      stacked_class_radii(), device="cpu")
    one = fn(*(torch.tensor(a)[None] for a in (pcld, mask, ctr_of, kp_of)))
    two = fn(*(torch.tensor(np.stack([a, a]))
               for a in (pcld, mask, ctr_of, kp_of)))
    assert two.poses.shape == (2, N_CLS, 3, 4)
    assert torch.equal(two.poses[0], one.poses[0])
    assert torch.equal(two.poses[1], one.poses[0])


def test_emptied_class_gets_identity(jax_pallas_winner):
    """A class predicted but emptied by the mask refinement gets the
    identity pose (pose.py:153-158 of the JAX package): class 3's points
    copy class 1's points and votes, so both center modes coincide and
    the refinement's first-index tie rule moves every class-3 point to
    class 1."""
    pcld, mask, ctr_of, kp_of = _votes(4, n_obj=2)
    a = np.flatnonzero(mask == 1)
    b = np.flatnonzero(mask == 3)
    pcld[b], ctr_of[:, b], kp_of[:, b] = pcld[a], ctr_of[:, a], kp_of[:, a]
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    kw = dict(n_cls=N_CLS, n_kps=8, k=128, bandwidth=0.08, max_iter=300)
    want = jax_cal_frame_poses(
        jnp.asarray(pcld), jnp.asarray(mask), jnp.asarray(ctr_of),
        jnp.asarray(kp_of), jnp.asarray(mesh_kps), jnp.asarray(radii), **kw)
    got = cal_frame_poses(
        torch.tensor(pcld), torch.tensor(mask), torch.tensor(ctr_of),
        torch.tensor(kp_of), torch.tensor(mesh_kps), torch.tensor(radii),
        **kw)
    np.testing.assert_array_equal(np.asarray(want.poses)[3],
                                  np.eye(3, 4, dtype=np.float32))
    np.testing.assert_array_equal(got.poses.numpy()[3],
                                  np.eye(3, 4, dtype=np.float32))
    assert bool(got.present[3])
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=1e-4)


def test_pvn3d_bfloat16_forward():
    """compute_dtype="bfloat16": both packages compute in bf16 with f32
    weights and BN statistics; held to bf16 rounding through ~60 layers
    (5% of each output's scale) and seg argmax agreement > 0.99."""
    cfg = small_model_cfg("bfloat16")
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=13)
    rng = np.random.RandomState(13)
    n, h, w = cfg.n_sample_points, cfg.image_height, cfg.image_width
    xyz = (rng.rand(1, n, 3).astype(np.float32) - 0.5) * 0.3
    batch = [np.concatenate([xyz, rng.randn(1, n, 6).astype(np.float32)
                             * 0.5], -1),
             (rng.randn(1, h, w, 3) * 0.3).astype(np.float32),
             rng.choice(h * w, size=(1, n), replace=False).astype(np.int32)]
    want = jax.jit(JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False).apply)(
        variables, *(jnp.asarray(x) for x in batch))
    model = PVN3D(to_port(cfg))
    model.load_state_dict(port_sd, strict=True)
    with torch.inference_mode():
        got = model(*(torch.tensor(x) for x in batch))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        ref = np.asarray(want[k])
        err = np.abs(got[k].numpy() - ref).max()
        assert err < 5e-2 * np.abs(ref).max(), f"{k}: {err}"
    agree = (got["seg_logits"].numpy().argmax(-1)
             == np.asarray(want["seg_logits"]).argmax(-1)).mean()
    assert agree > 0.99


def test_mean_shift_fit_matches(jax_pallas_winner):
    """Winner mode against the JAX package's on the same hypotheses, and
    dense mode (the literal fixed point, kept as the oracle) against
    winner mode: same labels and counts, modes within the stop rule's
    slack (the JAX package's own bound, tests/test_inference.py:155)."""
    rng = np.random.RandomState(6)
    h, k = 12, 128
    modes = rng.randn(h, 2, 3) * 0.1
    pick = rng.randint(0, 2, (h, k))
    pts = (modes[np.arange(h)[:, None], pick]
           + rng.randn(h, k, 3) * 0.02).astype(np.float32)
    msk = rng.rand(h, k) < 0.8
    msk[5] = False
    jc, jl, jn = jax_meanshift.mean_shift_fit(jnp.asarray(pts),
                                              jnp.asarray(msk), 0.08)
    c, lab, n = mean_shift_fit(torch.tensor(pts), torch.tensor(msk), 0.08)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    dc, dl, dn = mean_shift_fit(torch.tensor(pts), torch.tensor(msk), 0.08,
                                mode="dense")
    np.testing.assert_array_equal(dl.numpy(), lab.numpy())
    np.testing.assert_array_equal(dn.numpy(), n.numpy())
    np.testing.assert_allclose(dc.numpy(), c.numpy(), atol=5e-4)
