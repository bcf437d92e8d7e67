"""The port's frame preprocessing and depth geometry against the JAX
package's: morphology, the 5x5 median, the top-valid mask, depth
completion, normals, unprojection and projection, on the same seeded
numpy maps.  The JAX functions take one (H, W) map; the port's take a
batch, so each batch is held against the JAX function map by map."""
import numpy as np
import pytest

import jax.numpy as jnp

from pvn3d_tpu.geometry import cloud as jax_cloud
from pvn3d_tpu.ops import preprocess as jax_pre

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.geometry import cloud  # noqa: E402
from pvn3d_tpu_torch.ops import preprocess as pre  # noqa: E402

K = np.array([[572.4, 0, 40.0], [0, 573.5, 30.0], [0, 0, 1]], np.float32)
SIZES = [(60, 80), (120, 160)]


def scene_depth(seed=0, h=120, w=160):
    """Metres: a slanted plane, a box with surface noise, dropout holes,
    empty rows at the top, an all-empty column, and depths near the
    inversion limit (2.96 m) and in (0.01, 0.1]."""
    rng = np.random.RandomState(seed)
    d = np.full((h, w), 1.2, np.float32)
    d += np.linspace(0, 0.3, w, dtype=np.float32)[None, :]
    r0, r1, c0, c1 = h // 3, 2 * h // 3, w // 3, 2 * w // 3
    d[r0:r1, c0:c1] = 0.8
    d[r0:r1, c0:c1] += 0.02 * rng.randn(r1 - r0, c1 - c0)
    for _ in range(h * w // 800):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        d[y:y + rng.randint(2, 8), x:x + rng.randint(2, 8)] = 0.0
    d[:h // 20] = 0.0
    d[:, w // 2] = 0.0
    d[3 * h // 4:3 * h // 4 + 5, 5:15] = 2.96
    d[3 * h // 4 + 5:3 * h // 4 + 10, 5:15] = 0.05
    return d.astype(np.float32)


def batch_of(maps):
    return torch.tensor(np.stack(maps))


def jax_each(fn, maps, *args, **kw):
    return np.stack([np.asarray(fn(jnp.asarray(m), *args, **kw))
                     for m in maps])


def random_maps(seed, h=23, w=31, n=2):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w) * (rng.rand(h, w) > 0.3)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("size", [3, 5, 9])
def test_dilate_full_equal(size):
    maps = random_maps(size)
    got = pre._dilate_full(batch_of(maps), size).numpy()
    np.testing.assert_array_equal(got, jax_each(jax_pre._dilate_full, maps,
                                                size))


@pytest.mark.parametrize("size", [5, 7])
def test_erode_full_equal(size):
    maps = random_maps(size + 10)
    got = pre._erode_full(batch_of(maps), size).numpy()
    np.testing.assert_array_equal(got, jax_each(jax_pre._erode_full, maps,
                                                size))


@pytest.mark.parametrize("size", [3, 5, 7])
def test_dilate_cross_equal(size):
    maps = random_maps(size + 20)
    got = pre._dilate_cross(batch_of(maps), size).numpy()
    np.testing.assert_array_equal(got, jax_each(jax_pre._dilate_cross, maps,
                                                size))


@pytest.mark.parametrize("case", ["random", "ties", "no_valid"])
def test_median5_equal(case):
    maps = random_maps(7)
    if case == "ties":       # few distinct values: ties in every window
        maps = [np.round(m * 3) / 3 for m in maps]
    elif case == "no_valid":
        maps = [np.zeros_like(m) for m in maps]
    got = pre._median5(batch_of(maps)).numpy()
    np.testing.assert_array_equal(got, jax_each(jax_pre._median5, maps))


@pytest.mark.parametrize("case", ["scene", "empty_columns", "no_valid"])
def test_top_valid_mask_equal(case):
    maps = [scene_depth(1, 60, 80), scene_depth(2, 60, 80)]
    if case == "empty_columns":
        for m in maps:
            m[:, ::7] = 0.0
    elif case == "no_valid":
        maps = [np.zeros_like(m) for m in maps]
    got = pre._top_valid_mask(batch_of(maps)).numpy()
    want = jax_each(jax_pre._top_valid_mask, maps)
    np.testing.assert_array_equal(got, want)
    if case != "scene":
        # A column with no valid pixel is masked whole (argmax of an
        # all-False column is row 0).
        assert got[:, :, 0].all()


def test_bilateral5_close():
    maps = [scene_depth(4, 60, 80), scene_depth(5, 60, 80)]
    got = pre._bilateral5(batch_of(maps), 0.5, 2.0).numpy()
    want = jax_each(jax_pre._bilateral5, maps, 0.5, 2.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("r", [0, 1, 2])
def test_box_blur_close(r):
    maps = random_maps(30 + r)
    got = pre._box_blur(batch_of(maps), r).numpy()
    np.testing.assert_allclose(got, jax_each(jax_pre._box_blur_jnp, maps, r),
                               atol=1e-6)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("seed", [0, 3])
def test_fill_in_multiscale_close(seed, hw):
    maps = [scene_depth(seed, *hw), scene_depth(seed + 10, *hw)]
    got = pre.fill_in_multiscale(batch_of(maps)).numpy()
    want = jax_each(jax_pre.fill_in_multiscale_jnp, maps)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want > 0.01).mean() > (np.stack(maps) > 0.01).mean()


def test_fill_in_multiscale_extrapolate_close():
    maps = [scene_depth(6, 60, 80), scene_depth(7, 60, 80)]
    got = pre.fill_in_multiscale(batch_of(maps), extrapolate=True).numpy()
    want = jax_each(jax_pre.fill_in_multiscale_jnp, maps, extrapolate=True)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fill_in_multiscale_no_valid_pixel():
    maps = [np.zeros((60, 80), np.float32)] * 2
    got = pre.fill_in_multiscale(batch_of(maps)).numpy()
    np.testing.assert_array_equal(
        got, jax_each(jax_pre.fill_in_multiscale_jnp, maps))


@pytest.mark.parametrize("cam_scale", [1.0, 10000.0])
def test_fill_missing_close(cam_scale):
    maps = [scene_depth(8, 60, 80) * cam_scale,
            scene_depth(9, 60, 80) * cam_scale]
    got = pre.fill_missing(batch_of(maps), cam_scale).numpy()
    want = jax_each(jax_pre.fill_missing_jnp, maps, cam_scale)
    np.testing.assert_allclose(got / cam_scale, want / cam_scale, atol=1e-5)


def assert_normals_close(got, want, p):
    """Within 1e-4, except pixels whose camera-facing flip was decided by
    rounding: each has |n.p| < 1e-6, and they are at most 0.1%."""
    off = np.abs(got - want).max(axis=-1) > 1e-4
    ndotp = np.abs((want * p).sum(axis=-1))
    assert (ndotp[off] < 1e-6).all(), ndotp[off].max()
    assert off.mean() <= 1e-3, off.mean()


def camera_points(depth_maps, ks):
    """The JAX unprojection of each map: (B, H, W, 3)."""
    return np.stack([np.asarray(jax_cloud.depth_to_cloud_map(
        jnp.asarray(d), jnp.asarray(k))[0]) for d, k in zip(depth_maps, ks)])


@pytest.mark.parametrize("smooth", [0, 2])
@pytest.mark.parametrize("hw", SIZES)
def test_normals_close(hw, smooth):
    maps = [scene_depth(2, *hw), scene_depth(12, *hw)]
    ks = np.stack([K, K * np.float32([[1.1], [0.9], [1]])])
    got = pre.normals_from_depth_map(batch_of(maps), torch.tensor(ks),
                                     smooth=smooth).numpy()
    want = np.stack([np.asarray(jax_pre.normals_from_depth_map_jnp(
        jnp.asarray(d), jnp.asarray(k), smooth=smooth))
        for d, k in zip(maps, ks)])
    assert_normals_close(got, want, camera_points(maps, ks))
    norm = np.linalg.norm(got, axis=-1)
    assert np.all((np.abs(norm - 1) < 1e-5) | (norm == 0))
    assert (norm > 0).mean() > 0.5


def test_depth_to_cloud_map_close():
    maps = [scene_depth(3, 60, 80), scene_depth(4, 60, 80)]
    ks = np.stack([K, K * np.float32([[0.8], [1.2], [1]])])
    got, valid = cloud.depth_to_cloud_map(batch_of(maps) * 1000.0,
                                          torch.tensor(ks), 1000.0)
    for b in range(2):
        want, want_valid = jax_cloud.depth_to_cloud_map(
            jnp.asarray(maps[b] * 1000.0), jnp.asarray(ks[b]), 1000.0)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-6)
        np.testing.assert_array_equal(valid[b].numpy(),
                                      np.asarray(want_valid))


def test_depth_to_cloud_equal():
    d = scene_depth(5, 60, 80)
    got_c, got_i = cloud.depth_to_cloud(d, K)
    want_c, want_i = jax_cloud.depth_to_cloud(d, K)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_c, want_c, atol=1e-6)
    assert cloud.depth_to_cloud(np.zeros_like(d), K) == (None, None)


def test_project_points_close():
    """Points in front of the camera, behind it (mirrored, as the
    reference's plain division) and at z = 0 (the sign-keeping guard)."""
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.3, 0.3, (2, 200, 3)).astype(np.float32)
    p[0, :, 2] += 1.0
    p[1, :50, 2] = -np.abs(p[1, :50, 2]) - 0.5
    p[1, 50:60, 2] = 0.0
    p[1, 60:70, 2] = -0.0
    got = cloud.project_points(torch.tensor(p), torch.tensor(K), 1.0)
    want = np.asarray(jax_cloud.project_points(jnp.asarray(p),
                                               jnp.asarray(K), 1.0))
    assert got.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_batched_equals_single():
    maps = [scene_depth(s, 60, 80) for s in (20, 21, 22)]
    ks = torch.tensor(np.stack([K] * 3))
    both = pre.fill_missing(batch_of(maps))
    nrm = pre.normals_from_depth_map(both, ks)
    for b in range(3):
        one = pre.fill_missing(batch_of(maps[b:b + 1]))
        assert torch.equal(one[0], both[b])
        assert torch.equal(pre.normals_from_depth_map(one, ks[b:b + 1])[0],
                           nrm[b])

