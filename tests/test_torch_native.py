"""The port's host C++ twins (``pvn3d_tpu_torch/native/``) against the
JAX package's arms and the port's plain versions.

* The multi-scale fill twin against JAX's cv2 ``fill_in_multiscale`` at
  the JAX package's own twin tolerance (atol 1e-4, mean < 1e-6,
  ``tests/test_native_preprocess.py:34-48``), and against the port's
  torch fill (``impl="torch"``) at that fill's tolerance against cv2
  (``tests/test_torch_data.py``: max 2e-3), and within 1e-5 off the
  2-pixel border: the two part there, where the torch bilateral
  replicates the edge and cv2 (and the twin) mirror it.
* The normals twin against the numpy arm of both packages: atol 2e-3 and
  the same zero mask.
* ``fill_in_fast`` against JAX's (cv2) at ip_basic's defaults.
* The FPS twin's indices against the numpy plain version and the JAX
  package's FPS, in both start modes.
* A failed build raises with the compiler's output.
"""
import numpy as np
import pytest

from pvn3d_tpu.data import depth_completion as jax_dc
from pvn3d_tpu.data import normals as jax_normals
from pvn3d_tpu.native import farthest_point_sampling as jax_fps

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import native  # noqa: E402
from pvn3d_tpu_torch.data import depth_completion as dc  # noqa: E402
from pvn3d_tpu_torch.data.normals import normals_from_depth_map  # noqa
from pvn3d_tpu_torch.native import preprocess as native_pre  # noqa: E402
from pvn3d_tpu_torch.native.preprocess import (  # noqa: E402
    fill_in_multiscale_native, normals_from_depth_map_native)

K = np.array([[280.0, 0, 80.0], [0, 281.0, 60.0], [0, 0, 1]], np.float32)


def _depth_frame(seed=0, h=120, w=160, hole_frac=0.25):
    """A sloped plane and a blob with holes and sensor noise (the JAX
    package's test frame)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.8 + 0.6 * ys / h + 0.2 * xs / w
    blob = ((ys - h / 2) ** 2 + (xs - w / 2) ** 2) < (min(h, w) / 4) ** 2
    d = np.where(blob, d - 0.3, d) + rng.randn(h, w).astype(np.float32) * 0.003
    d[rng.rand(h, w) < hole_frac] = 0.0
    return d


def _fill_c(d, extrapolate, blur):
    """The twin's C ABI at the wrapper's other settings: ``extrapolate``
    0/1, ``blur`` 0 (none) or 2 (bilateral)."""
    out = np.empty_like(d)
    native_pre._library().pvn3d_fill_multiscale(
        d, d.shape[0], d.shape[1], native_pre.FILL_MAX_DEPTH,
        native_pre.FILL_NEAR_BIN, native_pre.FILL_MED_BIN, extrapolate,
        blur, out)
    return out


@pytest.mark.parametrize("seed,extrapolate", [(0, False), (1, False),
                                              (2, True)])
def test_fill_twin_matches_cv2(seed, extrapolate):
    d = _depth_frame(seed)
    want = jax_dc.fill_in_multiscale(d.copy(), extrapolate=extrapolate)
    got = (_fill_c(d.copy(), 1, native_pre.FILL_BLUR_BILATERAL)
           if extrapolate else fill_in_multiscale_native(d.copy()))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.mean(np.abs(got - want)) < 1e-6


def test_fill_twin_blur_none_exact():
    d = _depth_frame(3)
    np.testing.assert_array_equal(
        _fill_c(d.copy(), 0, 0),
        jax_dc.fill_in_multiscale(d.copy(), blur_type="none"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_missing_dispatch(seed):
    """``impl="auto"`` runs the twin; against the torch plain version and
    JAX's cv2 arm through ``fill_missing`` in sensor units."""
    d = _depth_frame(seed) * 10000.0
    auto = dc.fill_missing(d.copy(), 10000.0)
    np.testing.assert_array_equal(
        auto, fill_in_multiscale_native(d / 10000.0) * 10000.0)
    plain = dc.fill_missing(d.copy(), 10000.0, impl="torch")
    err = np.abs(auto - plain) / 10000.0
    assert err.max() <= 2e-3
    # Off the 2-pixel border the bilateral's border modes do not reach.
    assert err[2:-2, 2:-2].max() <= 1e-5
    want = jax_dc.fill_missing(d.copy(), 10000.0, impl="numpy")
    np.testing.assert_allclose(auto / 10000.0, want / 10000.0, atol=1e-4)
    with pytest.raises(ValueError, match="impl"):
        dc.fill_missing(d, 10000.0, impl="numpy")


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_fill_in_fast_matches_jax(seed):
    """ip_basic's ``fill_in_fast`` against JAX's (cv2) at its defaults:
    within 1e-5 m (cv2's bilateral reads its colour weights from a
    table)."""
    d = _depth_frame(seed)
    want = jax_dc.fill_in_fast(d.copy())
    got = dc.fill_in_fast(d.copy())
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        dc.fill_missing(d * 1000.0, 1000.0, fill_type="fast") / 1000.0,
        jax_dc.fill_missing(d * 1000.0, 1000.0, fill_type="fast") / 1000.0,
        atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_normals_twin_matches_numpy(seed):
    filled = jax_dc.fill_in_multiscale(_depth_frame(seed))
    plain = normals_from_depth_map(filled, K, impl="numpy")
    np.testing.assert_array_equal(
        plain, jax_normals.normals_from_depth_map(filled, K, impl="numpy"))
    got = normals_from_depth_map(filled, K)
    np.testing.assert_array_equal(got,
                                  normals_from_depth_map_native(filled, K))
    np.testing.assert_array_equal(got == 0, plain == 0)
    np.testing.assert_allclose(got, plain, atol=2e-3)
    # JAX's own twin (its build adds -march=native): float rounding.
    np.testing.assert_allclose(
        got, jax_normals.normals_from_depth_map(filled, K), atol=1e-6)


def test_normals_twin_without_smoothing_and_scaled():
    d = _depth_frame(2) * 1000.0
    got = normals_from_depth_map(d, K, cam_scale=1000.0, smooth=0)
    want = normals_from_depth_map(d, K, cam_scale=1000.0, smooth=0,
                                  impl="numpy")
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (normals_from_depth_map(np.zeros((60, 80), np.float32),
                                   K) == 0).all()


@pytest.mark.parametrize("init_center", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_fps_twin_matches_numpy_and_jax(init_center, seed):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(3000, 3) * [0.2, 0.1, 0.05]).astype(np.float32)
    got = native.fps_indices(pts, 16, init_center=init_center, seed=seed)
    want = native.fps_indices(pts, 16, init_center=init_center, seed=seed,
                              impl="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.farthest_point_sampling(pts, 16, init_center, seed),
        jax_fps(pts, 16, init_center=init_center, seed=seed))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: the build raises
    (with the compiler's output), and nothing is left in the build dir."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no" / "g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.load_library("fps")
    with pytest.raises(RuntimeError, match="cannot run"):
        normals_from_depth_map(np.ones((8, 8), np.float32), K)
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build_library(str(bad))
    assert not any(p.suffix in (".so", ".tmp")
                   for p in (tmp_path / "build").iterdir())
