"""The port's on-device training build against the JAX package's
(``ops/augment_device.py``, the training half of
``data/device_frame.py``).

JAX computes both sides of every "maybe" and draws from ``jax.random``;
the port draws a frame's values from a CPU ``torch.Generator`` first and
applies them.  Each apply is held against its JAX function given the same
drawn values: the test replaces ``jax.random.uniform``, ``randint``,
``normal`` and ``permutation`` (``monkeypatch``) with queues of the port's
draws, in the order the JAX function takes them, and feeds the port's
noise fields as JAX's normals.  The images agree within 1e-4 on the
0-255 scale where only float rounding parts them (5e-4 for a dense
31 x 31 kernel, 1e-3 through the jitter's four ops and the noise
stack's chain); ``add_real_back`` is exact.  The whole build with
``augment=False`` and JAX's own priorities equals JAX's sample dict,
with the fill and the normals at the tolerances of
``tests/test_torch_preprocess.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.data import device_frame as jax_frame
from pvn3d_tpu.ops import augment_device as jax_aug

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.data import device_frame  # noqa: E402
from pvn3d_tpu_torch.ops import augment_device as aug  # noqa: E402
from tests.test_torch_preprocess import (assert_normals_close,  # noqa: E402
                                         scene_depth)

H, W = 40, 56


def _img(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    smooth = np.stack([(xx * 4 + yy * 3) % 256, (xx * 2 + 70) % 256,
                       (yy * 6) % 256], -1)
    noise = rng.randint(0, 256, (H, W, 3))
    return np.where(rng.rand(H, W, 1) < 0.5, smooth, noise).astype(
        np.float32)


class _Draws:
    """Replaces JAX's random calls by queues of given values."""

    def __init__(self, monkeypatch, uniform=(), randint=(), normal=(),
                 perm=None):
        self.u, self.r, self.n = list(uniform), list(randint), list(normal)
        monkeypatch.setattr(jax.random, "uniform", self._uniform)
        monkeypatch.setattr(jax.random, "randint", self._randint)
        monkeypatch.setattr(jax.random, "normal", self._normal)
        if perm is not None:
            monkeypatch.setattr(jax.random, "permutation",
                                lambda key, n: jnp.asarray(perm))

    def _uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                 maxval=1.0):
        return jnp.float32(self.u.pop(0))

    def _randint(self, key, shape, minval, maxval):
        return jnp.int32(self.r.pop(0))

    def _normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.n.pop(0))

    def done(self):
        assert not (self.u or self.r or self.n)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_random_fields_are_counter_based():
    a = aug.uniform_field(123, (5, 7), "cpu")
    assert torch.equal(a, aug.uniform_field(123, (5, 7), "cpu"))
    assert not torch.equal(a, aug.uniform_field(124, (5, 7), "cpu"))
    u = aug.uniform_field(7, (200_000,), "cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5e-3
    n = aug.normal_field(9, (200_000,), "cpu")
    assert abs(float(n.mean())) < 1e-2 and abs(float(n.std()) - 1) < 1e-2
    # the field is a function of the element index alone
    assert torch.equal(aug.uniform_field(5, (10,), "cpu")[:4],
                       aug.uniform_field(5, (4,), "cpu"))


def test_draws_follow_the_generator():
    d1 = device_frame.draw_train_frame(torch.Generator().manual_seed(3))
    d2 = device_frame.draw_train_frame(torch.Generator().manual_seed(3))
    assert d1 == d2
    g = device_frame.step_generator(0, 5)
    assert torch.equal(torch.rand(3, generator=g), torch.rand(
        3, generator=device_frame.step_generator(0, 5)))
    assert not torch.equal(torch.rand(3, generator=device_frame.
                                      step_generator(0, 6)),
                           torch.rand(3, generator=device_frame.
                                      step_generator(0, 5)))


def test_hsv_round_trip_matches_jax():
    img = _img(1)
    h, s, v = aug.rgb_to_hsv(torch.as_tensor(img))
    jh, js, jv = jax_aug.rgb_to_hsv(jnp.asarray(img))
    for a, b in ((h, jh), (s, js), (v, jv)):
        _close(a, b, 1e-4)
    _close(aug.hsv_to_rgb(h, s, v), jax_aug.hsv_to_rgb(jh, js, jv), 1e-4)
    _close(aug.hsv_to_rgb(h, s, v), img, 1e-3)


def test_hsv_gain_matches_jax(monkeypatch):
    img = _img(2)
    fs, fv = aug.draw_hsv_gain(torch.Generator().manual_seed(1),
                               (1.25, 1.45), (1.15, 1.35))
    draws = _Draws(monkeypatch, uniform=[fs, fv])
    want = jax_aug.hsv_gain_jnp(jax.random.PRNGKey(0), jnp.asarray(img),
                                (1.25, 1.45), (1.15, 1.35))
    draws.done()
    _close(aug.hsv_gain(torch.as_tensor(img), fs, fv), want, 1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_matches_jax(monkeypatch, seed):
    img = _img(seed)
    d = aug.draw_color_jitter(torch.Generator().manual_seed(seed))
    draws = _Draws(monkeypatch, uniform=[d["fb"], d["fc"], d["fs"],
                                         d["fh"]], perm=d["perm"])
    want = jax_aug.color_jitter_jnp(jax.random.PRNGKey(seed),
                                    jnp.asarray(img))
    draws.done()
    _close(aug.color_jitter(torch.as_tensor(img), d), want, 1e-3)


def test_conv2d_same_matches_jax():
    """1e-4, and 5e-4 for a dense 31 x 31 kernel: 961 float32 products
    summed in two orders."""
    img = _img(3)
    rng = np.random.RandomState(0)
    for k, atol in ((3, 1e-4), (5, 1e-4), (31, 5e-4)):
        kern = rng.rand(k, k).astype(np.float32)
        kern /= kern.sum()
        _close(aug.conv2d_same(torch.as_tensor(img), torch.as_tensor(kern)),
               jax_aug._conv2d_same(jnp.asarray(img), jnp.asarray(kern)),
               atol)


@pytest.mark.parametrize("angle_u,length_u", [
    (0.0, 0.99), (0.1, 0.5), (0.25, 0.0), (0.37, 0.71), (0.5, 0.33),
    (0.62, 0.9), (0.875, 0.2), (0.999, 0.999)])
def test_blur_kernels_match_jax(monkeypatch, angle_u, length_u):
    img = _img(4)
    draws = _Draws(monkeypatch, uniform=[angle_u, length_u, 0.1, 0.4,
                                         0.9, 0.7, 0.5])
    want_motion = jax_aug.motion_blur_jnp(jax.random.PRNGKey(0),
                                          jnp.asarray(img))
    want_gauss5 = jax_aug.gaussian_blur_jnp(jax.random.PRNGKey(0),
                                            jnp.asarray(img))
    want_gauss3 = jax_aug.gaussian_blur_jnp(jax.random.PRNGKey(0),
                                            jnp.asarray(img))
    want_sharp = jax_aug.sharpen_jnp(jax.random.PRNGKey(0),
                                     jnp.asarray(img))
    draws.done()
    t = torch.as_tensor(img)
    _close(aug.motion_blur(t, angle_u, length_u), want_motion, 1e-4)
    _close(aug.gaussian_blur(t, 0.1, 0.4), want_gauss5, 1e-4)
    _close(aug.gaussian_blur(t, 0.9, 0.7), want_gauss3, 1e-4)
    _close(aug.sharpen(t, 0.5), want_sharp, 1e-3)


def _ycb_queue(d, img_shape):
    return dict(
        uniform=[d["fs"], d["fv"], d["sharpen_u"], d["center_u"],
                 d["motion_u"], d["angle_u"], d["length_u"], d["gauss_u"],
                 d["use5_u"], d["sigma_u"], d["sigma_gate_u"],
                 d["extra_u"]],
        randint=[d["sigma15"], d["sigma25"]],
        normal=[aug.normal_field(d["noise_seed"], img_shape, "cpu").numpy(),
                aug.normal_field(d["extra_seed"], img_shape,
                                 "cpu").numpy()])


@pytest.mark.parametrize("seed", range(6))
def test_noise_stack_ycb_matches_jax(monkeypatch, seed):
    img = _img(seed)
    d = aug.draw_noise_ycb(torch.Generator().manual_seed(seed))
    if seed < 3:        # take every branch in some cases
        d.update(sharpen_u=0.9, motion_u=0.85, gauss_u=0.95,
                 extra_u=0.9 if seed else 0.1)
    draws = _Draws(monkeypatch, **_ycb_queue(d, img.shape))
    want = jax_aug.rgb_add_noise_ycb_jnp(jax.random.PRNGKey(seed),
                                         jnp.asarray(img))
    draws.done()
    _close(aug.rgb_add_noise_ycb(torch.as_tensor(img), d), want, 1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_noise_stack_lm_matches_jax(monkeypatch, seed):
    img = _img(seed)
    d = aug.draw_noise_lm(torch.Generator().manual_seed(seed))
    if seed < 2:
        d.update(motion_u=0.9, gauss_u=0.9)
    draws = _Draws(monkeypatch, uniform=[
        d["fs"], d["fv"], d["motion_u"], d["angle_u"], d["length_u"],
        d["gauss_u"], d["use5_u"], d["sigma_u"]])
    want = jax_aug.rgb_add_noise_lm_jnp(jax.random.PRNGKey(seed),
                                        jnp.asarray(img))
    draws.done()
    _close(aug.rgb_add_noise_lm(torch.as_tensor(img), d), want, 1e-3)


def test_add_real_back_is_exact():
    rng = np.random.RandomState(5)
    rgb = rng.rand(H, W, 3).astype(np.float32) * 255
    labels = (rng.rand(H, W) < 0.3).astype(np.uint8)
    depth = (rng.rand(H, W) * (rng.rand(H, W) < 0.6)).astype(np.float32)
    back_rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    back_depth = rng.rand(H, W).astype(np.float32)
    back_label = (rng.rand(H, W) < 0.2).astype(np.uint8)
    got = aug.add_real_back(*(torch.as_tensor(x) for x in (
        rgb, labels, depth, back_rgb, back_depth, back_label)))
    want = jax_aug.add_real_back_jnp(*(jnp.asarray(x) for x in (
        rgb, labels, depth, back_rgb, back_depth, back_label)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _raw_batch(b=2, seed=0, n_inst=3, n_classes=22):
    from pvn3d_tpu.utils.assets import get_ctr, get_kps
    rng = np.random.RandomState(seed)
    h, w = 60, 80
    depth = np.stack([scene_depth(seed + i, h, w) for i in range(b)])
    label = np.zeros((b, h, w), np.uint8)
    cls_ids = np.zeros((b, 4), np.int32)
    rts = np.zeros((b, 4, 3, 4), np.float32)
    kps = np.zeros((b, 4, 8, 3), np.float32)
    ctrs = np.zeros((b, 4, 3), np.float32)
    for i in range(b):
        for j in range(n_inst):
            c = (5 * j + i) % (n_classes - 1) + 1
            label[i, 10 + 15 * j:22 + 15 * j, 10:40 + 5 * j] = c
            cls_ids[i, j] = c
            rts[i, j] = np.concatenate(
                [np.eye(3)[[1, 2, 0] if j % 2 else [0, 1, 2]],
                 [[0.05 * j], [0.01 * i], [0.8]]], axis=1)
            kps[i, j] = get_kps(c) if n_classes == 22 else get_kps(
                "ape", ds_type="linemod")
            ctrs[i, j] = get_ctr(c) if n_classes == 22 else get_ctr(
                "ape", ds_type="linemod")
    k = np.array([[572.4, 0, 40.0], [0, 573.5, 30.0], [0, 0, 1]],
                 np.float32)
    return {
        "rgb": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "depth": depth.astype(np.float32), "label_map": label,
        "cam_k": np.stack([k] * b), "cls_ids": cls_ids, "rts": rts,
        "mesh_kps": kps, "mesh_ctrs": ctrs,
        "is_syn": np.array([True, False][:b]),
        "do_jitter": np.ones(b, bool),
        "back_rgb": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "back_depth": rng.rand(b, h, w).astype(np.float32),
        "back_label": (rng.rand(b, h, w) < 0.2).astype(np.uint8)}


def test_build_targets_matches_jax():
    raw = _raw_batch(2, seed=1)
    rng = np.random.RandomState(3)
    cld = rng.rand(2, 500, 3).astype(np.float32)
    labels = rng.randint(0, 22, (2, 500)).astype(np.int32)
    labels[:, :200] = raw["cls_ids"][:, :1]
    got = device_frame.build_targets_device(
        *(torch.as_tensor(x) for x in (cld, labels, raw["cls_ids"],
                                       raw["rts"], raw["mesh_kps"],
                                       raw["mesh_ctrs"])), 22)
    for i in range(2):
        want = jax_frame.build_targets_device(
            *(jnp.asarray(x[i]) for x in (cld, labels, raw["cls_ids"],
                                          raw["rts"], raw["mesh_kps"],
                                          raw["mesh_ctrs"])), 22)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key]), atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("dataset", ["ycb", "linemod"])
def test_train_build_without_augmentation_matches_jax(dataset):
    """``augment=False`` with JAX's own priorities: choose, labels and
    the GT slots equal; the cloud, the targets and the filled depth
    within the fill's 1e-5; the normals as the raw path's test holds
    them; rgb exact (LineMOD's BGR flip included)."""
    n_classes = 22 if dataset == "ycb" else 2
    raw = _raw_batch(2, seed=2, n_classes=n_classes)
    b, h, w = raw["depth"].shape
    key = jax.random.PRNGKey(7)
    fill = dataset == "ycb"
    want = jax_frame.build_train_batch_device(
        {k: jnp.asarray(v) for k, v in raw.items()}, key, n_sample=512,
        n_classes=n_classes, fill=fill, dataset=dataset, augment=False)
    pri = np.stack([np.asarray(jax.random.uniform(
        jax.random.split(kb, 6)[4], (h * w,), jnp.float32, 1e-4, 1.0))
        for kb in jax.random.split(key, b)])
    got = device_frame.build_train_batch_device(
        {k: (v if k in ("is_syn", "do_jitter") else torch.as_tensor(v))
         for k, v in raw.items()}, torch.Generator().manual_seed(0),
        n_sample=512, n_classes=n_classes, fill=fill, dataset=dataset,
        augment=False, priorities=torch.as_tensor(pri))
    assert sorted(got) == sorted(want)
    for k in ("choose", "labels", "cls_ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["rgb"].numpy(), np.asarray(
        want["rgb"]))
    pc, wpc = got["pointcloud"].numpy(), np.asarray(want["pointcloud"])
    np.testing.assert_allclose(pc[..., :6], wpc[..., :6], atol=1e-5, rtol=0)
    for k in ("kp_targ_ofst", "ctr_targ_ofst", "kp_3ds", "ctr_3ds", "rts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert_normals_close(pc[..., 6:], wpc[..., 6:], pc[..., :3])


def test_train_build_with_augmentation_is_reproducible():
    """The same generator gives the same batch; another gives another;
    augmented rgb stays on the 0-255 scale; a synthetic frame takes the
    real background where its own label and depth are empty."""
    raw = {k: (v if k in ("is_syn", "do_jitter") else torch.as_tensor(v))
           for k, v in _raw_batch(2, seed=3).items()}
    raw["depth"][0, :5, :5] = 0.0
    raw["label_map"][0, :5, :5] = 0
    raw["back_label"][0, :5, :5] = 0
    runs = [device_frame.build_train_batch_device(
        raw, device_frame.step_generator(0, s), n_sample=512, n_classes=22)
        for s in (0, 0, 1)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert not torch.equal(runs[0]["pointcloud"], runs[2]["pointcloud"])
    rgb = runs[0]["rgb"]
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 255.0
    assert not torch.equal(rgb[0], raw["rgb"][0].float())
    single = device_frame.build_train_frame_device(
        {k: v[0] for k, v in raw.items()}, device_frame.step_generator(0, 0),
        n_sample=512, n_classes=22)
    assert single["pointcloud"].shape == (512, 9)
