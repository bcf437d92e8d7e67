"""The port's train and evaluate apps on fake trees, on the CPU, and the
evaluate path as a whole against the JAX package's.

The apps run ``Config.ycb()`` at full width by default; the tests
substitute the small model through ``apps.train.base_config`` (which the
evaluate app imports), on trees written at 120 x 160.  Against JAX: the
same fake test split through JAX's dataset, loader,
``make_inference_step`` and ``accumulate_batches`` and through the
port's evaluate app, on the same reference-checkpoint weights (carried
to JAX by ``convert_pvn3d``, to the port by ``--torch_ckpt``): the same
frames scored and every frame's ADD / ADD-S within 1e-4 m.  JAX's
winner pass runs its Pallas kernel in interpret mode, as in
``tests/test_torch_slice.py``.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data import frame as jax_frame
from pvn3d_tpu.data import loader as jax_loader
from pvn3d_tpu.data import normals as jax_normals
from pvn3d_tpu.data import ycb as jax_ycb
from pvn3d_tpu.inference import evaluator as jax_evaluator
from pvn3d_tpu.inference import pipeline as jax_pipeline
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.utils import assets as jax_assets

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.apps import evaluate, train  # noqa: E402
from pvn3d_tpu_torch.data import frame as port_frame  # noqa: E402
from pvn3d_tpu_torch.data import normals as port_normals  # noqa: E402
from pvn3d_tpu_torch.config import (ASSETS_DIR, Config,  # noqa: E402
                                    small_model_config)
from pvn3d_tpu_torch.inference import evaluator  # noqa: E402
from pvn3d_tpu_torch.tools.fake_data import (make_fake_linemod,  # noqa: E402
                                             make_fake_ycb)
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)


def _test_items(n):
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()][:n]


@pytest.fixture(scope="module")
def ycb_tree(tmp_path_factory):
    """Two real frames named as the vendored test list's first, two
    synthetic; class 1 in view; a mesh for every class."""
    root = str(tmp_path_factory.mktemp("apps"))
    items = _test_items(2) + ["data_syn/000001", "data_syn/000002"]
    return make_fake_ycb(root, h=120, w=160, cls_ids=(1, 2), items=items,
                         mesh_ids=range(1, 22))


@pytest.fixture
def small(monkeypatch):
    def base(dataset, cls):
        model = small_model_config()
        if dataset == "linemod":
            return dataclasses.replace(Config.linemod(cls), model=
                                       dataclasses.replace(model,
                                                           n_classes=2))
        return Config(model=model)
    monkeypatch.setattr(train, "base_config", base)
    monkeypatch.setattr(evaluate, "base_config", base)


def test_train_then_evaluate_on_the_cpu(ycb_tree, small, tmp_path, capsys):
    run = str(tmp_path / "run")
    common = ["--device", "cpu", "--workers", "0"]
    trainer = train.main(["--data_root", ycb_tree, "--file_list",
                          os.path.join(ycb_tree, "image_list.txt"),
                          "--checkpoint_dir", run, "--max_steps", "2",
                          "--batch_size", "2", "--log_every", "1"] + common)
    assert trainer.state.step == 2
    assert os.path.exists(os.path.join(run, "ckpt_2.pt"))
    out = capsys.readouterr().out
    assert out.count("[train it=") == 2
    summary = evaluate.main(["--data_root", ycb_tree, "--checkpoint_dir",
                             run, "--batch_size", "2"] + common)
    out = capsys.readouterr().out
    assert "evaluating from step 2" in out and "evaluated 2 frames" in out
    assert summary["per_class"][1]["n"] == 2
    assert np.isfinite(summary["all_adds_auc"])


def test_train_with_device_preprocess_and_resume(ycb_tree, small, tmp_path,
                                                 capsys):
    """The raw-train path (augmentation and the frame build in the step)
    takes a step, and a second run resumes from its checkpoint."""
    run = str(tmp_path / "run")
    argv = ["--data_root", ycb_tree, "--file_list",
            os.path.join(ycb_tree, "image_list.txt"), "--checkpoint_dir",
            run, "--batch_size", "2", "--device", "cpu", "--workers", "0",
            "--device_preprocess", "--log_every", "1", "--grad_accum", "2"]
    assert train.main(argv + ["--max_steps", "1"]).state.step == 1
    trainer = train.main(argv + ["--max_steps", "2"])
    assert trainer.state.step == 2
    assert trainer.cfg.train.grad_accum == 2
    assert "resumed from step 1" in capsys.readouterr().out


def test_linemod_train_and_evaluate(tmp_path, small, capsys):
    """An object other than ape (id 5, can): the evaluate app scores it
    against its own mesh, models/obj_05.ply (the JAX app reads
    obj_01.ply for every object, ROADMAP.md C5); the tree has no
    obj_01.ply."""
    # 260 x 360 still holds the fake frames' objects (rows from 160).
    lm = make_fake_linemod(str(tmp_path), n_frames=2, cls_id=5, h=260,
                           w=360, n_renders=1)
    assert not os.path.exists(os.path.join(lm, "models", "obj_01.ply"))
    run = str(tmp_path / "run")
    common = ["--dataset", "linemod", "--cls", "can", "--data_root", lm,
              "--device", "cpu", "--workers", "0", "--batch_size", "2",
              "--checkpoint_dir", run]
    assert train.main(common + ["--max_steps", "1"]).state.step == 1
    summary = evaluate.main(common + ["--device_preprocess"])
    out = capsys.readouterr().out
    assert "evaluated 2 frames" in out and "obj 5:" in out
    assert summary["n"] == 2


def test_train_config_overrides():
    args = train.build_argparser().parse_args([
        "--data_root", "x", "--grad_accum", "3", "--base_lr", "0.01",
        "--max_lr", "0.02", "--weight_decay", "0", "--bn_momentum", "0.5",
        "--bn_decay", "0.25", "--decay_step", "7", "--epochs", "2"])
    t = train.train_config(args).train
    assert (t.grad_accum, t.base_lr, t.max_lr, t.weight_decay,
            t.bn_momentum_init, t.bn_decay, t.bn_decay_step,
            t.n_total_epoch) == (3, 0.01, 0.02, 0.0, 0.5, 0.25, 7.0, 2)
    assert train.train_config(train.build_argparser().parse_args(
        ["--data_root", "x"])) == Config.ycb()


def test_dataset_factory_is_picklable(ycb_tree):
    import pickle
    args = train.build_argparser().parse_args(["--data_root", ycb_tree])
    factory = train.make_dataset_factory(args, "train", Config.ycb())
    ds = pickle.loads(pickle.dumps(factory))()
    assert ds.spec.n_sample_points == 12288 and ds.split == "train"


def test_evaluate_matches_jax(ycb_tree, small, tmp_path, monkeypatch,
                              jax_pallas_winner):
    cfg = small_model_cfg()
    variables, _, sd = jax_and_port_weights(cfg, seed=41)
    ckpt = str(tmp_path / "ref.pth.tar")
    torch.save({"model_state": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    jcfg = jax_config.Config(model=cfg)
    monkeypatch.setattr(evaluate, "base_config",
                        lambda dataset, cls: to_port(jcfg))
    monkeypatch.setattr(jax_frame, "normals_from_depth_map",
                        functools.partial(jax_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(port_frame, "normals_from_depth_map",
                        functools.partial(port_normals.normals_from_depth_map,
                                          impl="numpy"))

    mesh_pts, mesh_valid = jax_assets.stacked_mesh_points(ycb_tree, "ycb",
                                                          22)
    jstep = jax_pipeline.make_inference_step(
        jcfg, JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False), variables,
        jax_assets.stacked_mesh_kps("ycb"), jax_assets.stacked_class_radii(
            "ycb"), mesh_pts, mesh_valid)
    loader = jax_loader.DataLoader(functools.partial(
        jax_ycb.YCBDataset, ycb_tree, split="test", fill_depth=False,
        spec=jax_frame.FrameSpec(n_sample_points=cfg.n_sample_points)), 2)
    jev = jax_evaluator.PoseEvaluator(n_cls=22)
    n = jax_pipeline.accumulate_batches(
        lambda b: jstep({k: jnp.asarray(v) for k, v in b.items()}), loader,
        jev)

    made = []

    class Capture(evaluator.PoseEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(evaluator, "PoseEvaluator", Capture)
    evaluate.main(["--data_root", ycb_tree, "--torch_ckpt", ckpt,
                   "--device", "cpu", "--workers", "0", "--batch_size", "2",
                   "--no_fill_depth", "--dense_cnn"])
    ev = made[0]
    assert n == 2
    for got, want in ((ev.cls_add_dis, jev.cls_add_dis),
                      (ev.cls_adds_dis, jev.cls_adds_dis)):
        assert [len(x) for x in got] == [len(x) for x in want]
        np.testing.assert_allclose(np.concatenate(got[1:]),
                                   np.concatenate(want[1:]), atol=1e-4)
