"""The port's Occlusion-LineMOD split against the JAX package's: the info
parser, the fake-tree tool, the dataset's frames (masks read and labels
synthesised, host-built and raw), its skip rule and rejections, and the
evaluate app and the packer with ``--occ``.

Frames are held as ``tests/test_torch_data.py`` holds LineMOD's test
split: equal keys, dtypes and values, exactly (JAX's normals on their
numpy arm).  The evaluate app is held as ``tests/test_torch_apps.py``
holds it: the same frames scored and every frame's ADD / ADD-S within
1e-4 m of JAX's ``accumulate_batches`` on the same weights, JAX's winner
pass in Pallas interpret mode.  Trees are 288 x 384, which still hold
the fake frames' object boxes.
"""
import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data import frame as jax_frame
from pvn3d_tpu.data import loader as jax_loader
from pvn3d_tpu.data import normals as jax_normals
from pvn3d_tpu.data import occlusion_linemod as jax_occ
from pvn3d_tpu.inference import evaluator as jax_evaluator
from pvn3d_tpu.inference import pipeline as jax_pipeline
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.tools import fake_data as jax_fake
from pvn3d_tpu.utils import assets as jax_assets

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
Image = pytest.importorskip("PIL.Image")

from pvn3d_tpu_torch.apps import evaluate, train  # noqa: E402
from pvn3d_tpu_torch.data import frame  # noqa: E402
from pvn3d_tpu_torch.data import normals as port_normals  # noqa: E402
from pvn3d_tpu_torch.data import occlusion_linemod as occ  # noqa: E402
from pvn3d_tpu_torch.data.png import read_png  # noqa: E402
from pvn3d_tpu_torch.inference import evaluator  # noqa: E402
from pvn3d_tpu_torch.tools import fake_data  # noqa: E402
from pvn3d_tpu_torch.tools import preprocess_testset as pack  # noqa: E402
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

H, W, N_FRAMES = 288, 384, 4


@pytest.fixture(scope="module")
def occ_trees(tmp_path_factory):
    """The port tool's trees for ape without masks (labels synthesised)
    and with masks, and the JAX tool's tree without."""
    root = tmp_path_factory.mktemp("occ")
    out = {}
    for name, masks in (("synth", False), ("masks", True)):
        out[name] = fake_data.make_fake_occlusion_linemod(
            str(root / name), n_frames=N_FRAMES, h=H, w=W, with_masks=masks)
    out["jax"] = jax_fake.make_fake_occlusion_linemod(
        str(root / "jax"), n_frames=N_FRAMES, h=H, w=W)
    return out


@pytest.fixture
def jax_numpy_normals(monkeypatch):
    monkeypatch.setattr(jax_frame, "normals_from_depth_map",
                        functools.partial(jax_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(frame, "normals_from_depth_map", functools.partial(
        port_normals.normals_from_depth_map, impl="numpy"))


_INFO = {
    "annotated": "image size\n640 480\nape\nrotation:\n0.1 0.2 0.3\n"
                 "0.4 0.5 0.6\n0.7 0.8 0.9\ncenter:\n-0.1 0.02 1.5\n"
                 "extent:\n0.06 0.08 0.07\n",
    "exponents": "rotation:\n1e-1 -2.5E-2 3\n4 5 6\n7 8 +9\n"
                 "center:\n1.5e-3 -0.2 0.9\n",
    "truncated": "image size\n640 480\nape\nrotation:\n0.1 0.2\n",
    "no_center": "rotation:\n1 0 0\n0 1 0\n0 0 1\n",
    "nan": "rotation:\nnan 0 0\n0 1 0\n0 0 1\ncenter:\n0 0 1\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(_INFO) + ["missing"])
def test_parse_occ_info_matches_jax(tmp_path, name):
    path = str(tmp_path / "info_00000.txt")
    if name != "missing":
        with open(path, "w") as f:
            f.write(_INFO[name])
    got, want = occ.parse_occ_info(path), jax_occ.parse_occ_info(path)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == (3, 4)
        np.testing.assert_array_equal(got, want)
    assert (want is None) == (name not in ("annotated", "exponents"))


@pytest.mark.parametrize("masks", [False, True])
def test_fake_occ_tree_decodes_equal_to_jax(tmp_path, masks):
    a = jax_fake.make_fake_occlusion_linemod(
        str(tmp_path / "jax"), n_frames=3, h=96, w=128, seed=2,
        with_masks=masks)
    b = fake_data.make_fake_occlusion_linemod(
        str(tmp_path / "port"), n_frames=3, h=96, w=128, seed=2,
        with_masks=masks)
    n = 0
    for d, _, files in os.walk(a):
        for f in files:
            pa = os.path.join(d, f)
            pb = pa.replace(a, b)
            if f.endswith(".png"):
                with Image.open(pa) as im:
                    np.testing.assert_array_equal(read_png(pb),
                                                  np.array(im))
            else:
                with open(pa) as fa, open(pb) as fb:
                    assert fa.read() == fb.read(), f
            n += 1
    # 3 rgb + 3 depth + 2 info + the mesh, and 2 masks
    assert n == 9 + 2 * masks


def _datasets(root, **spec):
    port = occ.OcclusionLineMODDataset(
        root, "ape", spec=frame.FrameSpec(n_sample_points=1024, **spec))
    ref = jax_occ.OcclusionLineMODDataset(
        root, "ape", spec=jax_frame.FrameSpec(n_sample_points=1024, **spec))
    return port, ref


@pytest.mark.parametrize("tree", ["synth", "masks", "jax"])
@pytest.mark.parametrize("spec", [{}, {"keep_depth": True},
                                  {"device_preprocess": True}])
def test_occ_frames_equal_jax(occ_trees, jax_numpy_normals, tree, spec):
    """Host-built frames (and with the full-res depth kept for ICP) and
    the raw frames of ``--device_preprocess`` (JAX's occ dataset builds
    those through the same ``build_frame`` branch): equal to JAX's."""
    port, ref = _datasets(occ_trees[tree], **spec)
    assert port.ids == ref.ids and len(port) == N_FRAMES
    for i in range(N_FRAMES - 1):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if not spec:
        labels = port[0]["labels"]
        assert labels.max() == 1 and 0 < labels.mean() < 1


def test_synthesised_label_carves_the_occluder(occ_trees):
    """The 0.6 m strip in front of the object's left 20 columns fails
    the 2 cm depth test, so no label reaches more than the dilation's
    2 pixels into it."""
    port, ref = _datasets(occ_trees["synth"])
    rt = occ.parse_occ_info(os.path.join(port.pose_dir, "info_00000.txt"))
    depth = read_png(os.path.join(port.root, "RGB-D", "depth_noseg",
                                  "depth_00000.png")) / 1000.0
    k = occ.C.INTRINSICS["linemod"]
    got = port._synth_label(rt, depth.astype(np.float32), k)
    np.testing.assert_array_equal(got, ref._synth_label(
        rt, depth.astype(np.float32), k))
    assert got.sum() > 0
    strip = got[160:250, 220:240]
    assert strip[:, :18].sum() == 0


def test_occ_skip_rule_and_rejections(occ_trees):
    for root in (occ_trees["synth"], occ_trees["masks"]):
        port, ref = _datasets(root)
        assert port[N_FRAMES - 1] is None and ref[N_FRAMES - 1] is None
    for cls in (occ.OcclusionLineMODDataset,
                jax_occ.OcclusionLineMODDataset):
        with pytest.raises(ValueError, match="test-only"):
            cls(occ_trees["synth"], "ape", split="train")
        with pytest.raises(ValueError, match="not an Occlusion-LineMOD"):
            cls(occ_trees["synth"], "benchvise")
    assert occ.OCC_POSE_DIRS == jax_occ.OCC_POSE_DIRS


def _lm_cfg():
    return dataclasses.replace(small_model_cfg(), n_classes=2)


@pytest.fixture
def small_lm(monkeypatch):
    cfg = dataclasses.replace(jax_config.Config.linemod("ape"),
                              model=_lm_cfg())
    monkeypatch.setattr(evaluate, "base_config",
                        lambda dataset, cls: to_port(cfg))
    return cfg


def _capture(monkeypatch):
    made = []

    class Capture(evaluator.PoseEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(evaluator, "PoseEvaluator", Capture)
    return made


def test_evaluate_occ_matches_jax(occ_trees, small_lm, tmp_path,
                                  monkeypatch, jax_numpy_normals,
                                  jax_pallas_winner):
    """``evaluate --occ`` for ape against JAX's evaluation of the same
    split with the same weights (JAX's app scores against obj_01's mesh,
    ape's own), then ``--packed_dir`` on the packer's ``--occ`` shards:
    the same frames and ADDs again."""
    cfg = _lm_cfg()
    variables, _, sd = jax_and_port_weights(cfg, seed=44)
    ckpt = str(tmp_path / "ref.pth.tar")
    torch.save({"model_state": sd}, ckpt)
    root = occ_trees["synth"]

    kp = jax_assets.get_kps("ape", ds_type="linemod")
    ctr = jax_assets.get_ctr("ape", ds_type="linemod").reshape(1, 3)
    row = np.concatenate([kp, ctr])
    mesh_pts, mesh_valid = jax_assets.stacked_mesh_points(
        root, "linemod", n_cls=2, max_points=2000)
    jstep = jax_pipeline.make_inference_step(
        small_lm, JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False),
        variables, np.stack([np.zeros_like(row), row]),
        jax_assets.stacked_class_radii("linemod", 2), mesh_pts, mesh_valid)
    loader = jax_loader.DataLoader(functools.partial(
        jax_occ.OcclusionLineMODDataset, root, cls_type="ape",
        split="test", spec=jax_frame.FrameSpec(
            n_sample_points=cfg.n_sample_points)), 2)
    jev = jax_evaluator.PoseEvaluator(n_cls=2, ds_type="linemod")
    n = jax_pipeline.accumulate_batches(
        lambda b: jstep({k: jnp.asarray(v) for k, v in b.items()}), loader,
        jev, ds_type="linemod", obj_id=1)
    assert n == N_FRAMES - 1

    made = _capture(monkeypatch)
    common = ["--dataset", "linemod", "--cls", "ape", "--occ",
              "--data_root", root, "--torch_ckpt", ckpt, "--device", "cpu",
              "--batch_size", "2", "--dense_cnn"]
    evaluate.main(common + ["--workers", "0"])
    # The packer's command line packs at the full point budget; the
    # frames evaluated here are packed at the small model's.
    packed = str(tmp_path / "packed")
    assert pack.pack_dataset(occ.OcclusionLineMODDataset(
        root, "ape", spec=frame.FrameSpec(
            n_sample_points=cfg.n_sample_points)), packed,
        shard_size=2) == N_FRAMES - 1
    evaluate.main(common + ["--packed_dir", packed])
    assert len(made) == 2
    for ev in made:
        for got, want in ((ev.cls_add_dis, jev.cls_add_dis),
                          (ev.cls_adds_dis, jev.cls_adds_dis)):
            assert [len(x) for x in got] == [len(x) for x in want]
            np.testing.assert_allclose(np.concatenate(got[1:]),
                                       np.concatenate(want[1:]), atol=1e-4)


@pytest.mark.parametrize("extra", [[], ["--device_preprocess"]])
def test_evaluate_occ_scores_each_object_against_its_own_mesh(
        tmp_path, monkeypatch, capsys, extra):
    """Port only (``ROADMAP.md`` C5): can (id 5) on an occ tree whose
    meshes live in a separate ``--lm_root`` holding obj_05.ply and no
    obj_01.ply; the labels are synthesised from that mesh too.  With
    ``--device_preprocess`` the occ frames ship raw and are built in the
    step, as JAX's occ dataset does through ``build_frame``."""
    root = fake_data.make_fake_occlusion_linemod(
        str(tmp_path / "t"), n_frames=3, cls_type="can", h=H, w=W)
    lm = str(tmp_path / "lm")
    os.makedirs(lm)
    shutil.move(os.path.join(root, "models"), os.path.join(lm, "models"))
    assert os.listdir(os.path.join(lm, "models")) == ["obj_05.ply"]
    cfg = dataclasses.replace(jax_config.Config.linemod("can"),
                              model=_lm_cfg())
    monkeypatch.setattr(evaluate, "base_config",
                        lambda dataset, cls: to_port(cfg))
    made = _capture(monkeypatch)
    summary = evaluate.main(
        ["--dataset", "linemod", "--cls", "can", "--occ", "--data_root",
         root, "--lm_root", lm, "--checkpoint_dir", str(tmp_path / "run"),
         "--device", "cpu", "--workers", "0", "--batch_size", "2"] + extra)
    out = capsys.readouterr().out
    assert "evaluated 2 frames" in out and "obj 5:" in out
    assert summary["n"] == 2 and len(made[0].cls_add_dis[5]) == 2
    assert np.isfinite(made[0].cls_add_dis[5]).all()


def test_packer_command_line_packs_the_occ_split(occ_trees, tmp_path,
                                                 capsys):
    out = str(tmp_path / "packed")
    pack.main(["--dataset", "linemod", "--cls", "ape", "--occ",
               "--data_root", occ_trees["masks"], "--out", out,
               "--max_frames", "1", "--workers", "0"])
    assert "packed 1 frames" in capsys.readouterr().out
    batch = next(pack.iter_packed_batches(out, 1))
    assert batch["pointcloud"].shape == (1, 12288, 9)
    assert batch["cls_ids"][0, 0] == 1 and batch["labels"].max() == 1


def test_occ_flag_needs_linemod(tmp_path):
    with pytest.raises(SystemExit, match="--occ requires --dataset linemod"):
        evaluate.main(["--occ", "--data_root", str(tmp_path),
                       "--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    args = evaluate.build_argparser().parse_args(
        ["--dataset", "linemod", "--occ", "--data_root", "x", "--lm_root",
         "y"])
    factory = train.make_dataset_factory(args, "test", to_port(
        jax_config.Config.linemod("ape")))
    assert factory.func is occ.OcclusionLineMODDataset
    assert factory.keywords["lm_root"] == "y"
