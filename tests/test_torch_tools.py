"""The port's ``knn_normals``, offline FPS with ``tools/gen_obj_info.py``,
and ``tools/check_dataset.py`` against the JAX package's.

- ``knn_normals`` (torch, exact float64 k-NN) against JAX's
  (scikit-learn's kd-tree) on a plane and on random surfaces in general
  position: |n . n'| >= 1 - 1e-6 at every point, with the same
  orientation (n . n' > 0).
- FPS indices and ``gen_obj_info``'s files equal JAX's byte for byte
  (JAX runs its C++ twin where it builds, else the same numpy form).
- ``validate_frame`` gives JAX's list on sound and corrupted frames;
  ``render_overlay``'s PNG is the array JAX hands ``cv2.imwrite`` with
  its channels flipped back (cv2 reads BGR), bit for bit; the tool's
  ``main`` counts the same frames with violations as JAX's on fake YCB
  and LineMOD trees.
"""
import os

import numpy as np
import pytest

from pvn3d_tpu import native as jax_native
from pvn3d_tpu.data import normals as jax_normals
from pvn3d_tpu.tools import check_dataset as jax_check
from pvn3d_tpu.tools import gen_obj_info as jax_gen

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
pytest.importorskip("sklearn")

from pvn3d_tpu_torch import native  # noqa: E402
from pvn3d_tpu_torch.config import ASSETS_DIR, INTRINSICS  # noqa: E402
from pvn3d_tpu_torch.data.normals import knn_normals  # noqa: E402
from pvn3d_tpu_torch.data.png import read_png  # noqa: E402
from pvn3d_tpu_torch.tools import check_dataset, gen_obj_info  # noqa: E402
from pvn3d_tpu_torch.tools.fake_data import (make_fake_linemod,  # noqa: E402
                                             make_fake_ycb)


def _surface(kind, rng, n):
    uv = rng.uniform(-0.2, 0.2, (n, 2))
    if kind == "plane":
        z = 0.9 + 0.3 * uv[:, 0] - 0.2 * uv[:, 1]
    elif kind == "waves":
        z = 1.0 + 0.05 * np.sin(15 * uv[:, 0]) + 0.04 * np.cos(11 * uv[:, 1])
    else:                                   # a sphere cap facing the camera
        z = 1.2 - np.sqrt(0.3 ** 2 - (uv ** 2).sum(1))
    return np.concatenate([uv, z[:, None]], 1)


@pytest.mark.parametrize("kind,n,k,seed", [
    ("plane", 600, 50, 0), ("waves", 1500, 50, 1), ("waves", 800, 16, 2),
    ("sphere", 1000, 30, 3), ("plane", 20, 50, 4)])
def test_knn_normals_match_jax(kind, n, k, seed):
    rng = np.random.RandomState(seed)
    pts = _surface(kind, rng, n).astype(np.float32)
    got = knn_normals(pts, k=k, device="cpu")
    want = jax_normals.knn_normals(pts, k=k)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 3)
    dots = (got.astype(np.float64) * want).sum(1)
    assert dots.min() >= 1 - 1e-6
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-6)


def test_knn_normals_orient_to_the_viewpoint():
    pts = _surface("waves", np.random.RandomState(5), 500)
    for vp in ((0.0, 0.0, 0.0), (0.0, 0.0, 3.0), (2.0, -1.0, 1.0)):
        got = knn_normals(pts, k=20, viewpoint=vp, device="cpu")
        want = jax_normals.knn_normals(pts, k=20, viewpoint=vp)
        assert ((got * want).sum(1) >= 1 - 1e-6).all()
        assert ((got * (np.asarray(vp) - pts)).sum(1) >= 0).all()
    assert knn_normals(np.zeros((0, 3)), device="cpu").shape == (0, 3)


def test_knn_normals_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn_normals(np.zeros((4, 3)))


@pytest.mark.parametrize("sn,seed,center", [(8, 0, False), (20, 3, False),
                                            (12, None, False),
                                            (16, 0, True)])
def test_fps_matches_jax(sn, seed, center):
    pts = np.random.RandomState(7).uniform(-1, 1, (700, 3)).astype(
        np.float32)
    got = native.farthest_point_sampling(pts, sn, init_center=center,
                                         seed=seed)
    want = jax_native.farthest_point_sampling(pts, sn, init_center=center,
                                              seed=seed)
    np.testing.assert_array_equal(got, want)
    if center:
        ctr = (pts.max(axis=0) + pts.min(axis=0)) / 2.0
        d = np.sum((pts - ctr) ** 2, axis=1)
        np.testing.assert_array_equal(
            native._fps(pts, sn, int(np.argmax(d)), d),
            jax_native._fps_center_numpy(pts, sn))
    else:
        start = 0 if seed is None else \
            np.random.RandomState(seed).randint(700)
        np.testing.assert_array_equal(
            native._fps(pts, sn, start, np.full(700, np.inf)),
            jax_native._fps_numpy(pts, sn, start))


def _write_ply(path, pts, binary):
    head = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} "
            f"1.0\nelement vertex {len(pts)}\nproperty float x\n"
            "property float y\nproperty float z\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode())


@pytest.mark.parametrize("binary,scale,seed", [(False, 1000.0, 0),
                                               (True, 1.0, 5)])
def test_gen_obj_info_files_equal_jax(tmp_path, binary, scale, seed):
    pts = np.random.RandomState(seed).uniform(-40, 40, (900, 3)).astype(
        np.float32) * (1.0 if scale > 1 else 1e-3)
    ply = str(tmp_path / "obj.ply")
    _write_ply(ply, pts, binary)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    got = gen_obj_info.gen_one_mesh_info(ply, a, scale=scale, seed=seed)
    want = jax_gen.gen_one_mesh_info(ply, b, scale=scale, seed=seed)
    assert got == want
    names = sorted(os.listdir(b))
    assert names == sorted(os.listdir(a)) and len(names) == 8
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_gen_obj_info_command_line(tmp_path, capsys):
    pts = np.random.RandomState(1).uniform(-30, 30, (300, 3))
    ply = str(tmp_path / "obj.ply")
    _write_ply(ply, pts, False)
    out = str(tmp_path / "info")
    gen_obj_info.main(["--ply", ply, "--out", out, "--scale", "1000",
                       "--kp_counts", "8,4"])
    assert "'n_points': 300" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == [
        "center.txt", "corners.txt", "farthest.txt", "farthest4.txt",
        "radius.txt"]


def _sound_sample():
    n = 64
    rng = np.random.RandomState(0)
    cld = rng.rand(n, 3).astype(np.float32) * 0.2 + [0, 0, 0.8]
    cld = cld.astype(np.float32)
    labels = np.zeros(n, np.int32)
    labels[:20] = 1
    labels[20:30] = 3
    kp3 = np.stack([rng.rand(8, 3) * 0.2 + [0, 0, 0.8],
                    np.zeros((8, 3)),
                    rng.rand(8, 3) * 0.2 + [0, 0, 0.8]]).astype(np.float32)
    ctr3 = kp3.mean(1)
    kp_t = np.zeros((n, 8, 3), np.float32)
    ctr_t = np.zeros((n, 1, 3), np.float32)
    for i, c in ((0, 1), (2, 3)):
        m = labels == c
        kp_t[m] = cld[m, None, :] - kp3[i][None]
        ctr_t[m, 0] = cld[m] - ctr3[i][None]
    return {
        "pointcloud": np.concatenate([cld, np.zeros((n, 6), np.float32)],
                                     1),
        "labels": labels, "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t,
        "cls_ids": np.array([1, 0, 3]),
        "rts": np.zeros((3, 3, 4), np.float32),
        "kp_3ds": kp3, "ctr_3ds": ctr3,
    }


def _corrupt(sample, how):
    s = {k: np.array(v, copy=True) for k, v in sample.items()}
    if how == "kp":
        s["kp_targ_ofst"][5, 2] += 0.01
    elif how == "ctr":
        s["ctr_targ_ofst"][22, 0] -= 0.02
    elif how == "background_kp":
        s["kp_targ_ofst"][40] = 1.0
    elif how == "background_ctr":
        s["ctr_targ_ofst"][50] = -0.5
    elif how == "units":
        s["pointcloud"][:, :3] *= 1000.0
        s["kp_targ_ofst"] = np.zeros_like(s["kp_targ_ofst"])
        s["ctr_targ_ofst"] = np.zeros_like(s["ctr_targ_ofst"])
    elif how == "no_gt":
        del s["kp_3ds"], s["ctr_3ds"]
    return s


@pytest.mark.parametrize("how", ["sound", "kp", "ctr", "background_kp",
                                 "background_ctr", "units", "no_gt"])
def test_validate_frame_matches_jax(how):
    s = _corrupt(_sound_sample(), how)
    got = check_dataset.validate_frame(s)
    assert got == jax_check.validate_frame(s)
    assert (got == []) == (how in ("sound", "no_gt"))


def _first_items(n):
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()][:n]


def test_render_overlay_equals_jax(tmp_path, monkeypatch):
    s = _sound_sample()
    s["rgb"] = np.random.RandomState(1).randint(
        0, 256, (480, 640, 3)).astype(np.float32)
    k = INTRINSICS["ycb_K1"]
    written = {}
    monkeypatch.setattr(cv2, "imwrite",
                        lambda p, img: written.setdefault(p, img.copy())
                        is None)
    jax_check.render_overlay(s, k, "frame.jpg")
    path = str(tmp_path / "frame.png")
    check_dataset.render_overlay(s, k, path)
    got = read_png(path)
    np.testing.assert_array_equal(got, written["frame.jpg"][..., ::-1])
    assert (got != s["rgb"].astype(np.uint8)).any(-1).sum() > 100


@pytest.mark.parametrize("dataset", ["ycb", "linemod"])
def test_main_counts_like_jax(tmp_path, monkeypatch, capsys, dataset):
    root = str(tmp_path)
    if dataset == "ycb":
        data = make_fake_ycb(root, h=120, w=160, cls_ids=(1, 2),
                             items=_first_items(2))
        argv = ["--data_root", data]
    else:
        data = make_fake_linemod(root, n_frames=2, h=260, w=360)
        argv = ["--dataset", "linemod", "--cls", "ape", "--data_root", data]
    argv += ["--split", "test", "--n_frames", "2"]
    written = {}
    monkeypatch.setattr(cv2, "imwrite",
                        lambda p, img: written.setdefault(
                            os.path.basename(p), img.copy()) is None)
    want = jax_check.main(argv + ["--render_dir", str(tmp_path / "jax")])
    renders = str(tmp_path / "port")
    got = check_dataset.main(argv + ["--render_dir", renders])
    assert got == want == 0
    assert "checked 2 frames, 0 with violations" in capsys.readouterr().out
    for i in range(2):
        np.testing.assert_array_equal(
            read_png(os.path.join(renders, f"frame_{i:04d}.png")),
            written[f"frame_{i:04d}.jpg"][..., ::-1])
