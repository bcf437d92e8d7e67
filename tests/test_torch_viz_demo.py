"""The port's overlay drawing (``utils/viz.py``) and demo app against the
JAX package's, which draw with cv2.

- ``filled_circle`` equals ``cv2.circle(img, c, r, color, -1)`` bit for
  bit for radii 0-8 and centres inside, on and beyond the image border;
  ``draw_points`` and ``draw_pose_mesh`` equal JAX's bit for bit on the
  same points and poses.
- The whole demo on a fake YCB tree and a fake LineMOD tree, both
  packages on the same weights (JAX's checkpoint restore and cv2's
  writer replaced to hand them over): the port's PNG against the array
  JAX gave ``cv2.imwrite``, channels flipped (cv2 reads BGR), equal on at
  least 99.9% of the pixels.  The two packages' poses differ by ~1e-6 on
  the CPU, so a mesh vertex may round to a neighbouring pixel.  JAX's
  winner pass runs in Pallas interpret mode and its normals on their
  numpy arm; YCB depth is not filled (the two fills agree only to a
  tolerance).
"""
import dataclasses
import functools
import os
import types

import numpy as np
import pytest

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data import frame as jax_frame
from pvn3d_tpu.data import normals as jax_normals
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.utils import viz as jax_viz

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from pvn3d_tpu_torch.apps import demo, train  # noqa: E402
from pvn3d_tpu_torch.config import ASSETS_DIR  # noqa: E402
from pvn3d_tpu_torch.data import frame as port_frame  # noqa: E402
from pvn3d_tpu_torch.data import normals as port_normals  # noqa: E402
from pvn3d_tpu_torch.data.png import read_png  # noqa: E402
from pvn3d_tpu_torch.tools.fake_data import (make_fake_linemod,  # noqa: E402
                                             make_fake_ycb)
from pvn3d_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from pvn3d_tpu_torch.train.state import create_train_state  # noqa: E402
from pvn3d_tpu_torch.utils import viz  # noqa: E402
from pvn3d_tpu_torch.utils.weights import from_jax_variables  # noqa: E402
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)


@pytest.mark.parametrize("radius", range(9))
def test_filled_circle_equals_cv2(radius):
    h, w = 21, 26
    centres = [(x, y) for x in range(-radius - 2, w + radius + 2)
               for y in (-radius - 1, -radius, -1, 0, 1, radius, h // 2,
                         h - radius - 1, h - 1, h, h + radius - 1,
                         h + radius)]
    for cx, cy in centres:
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, (cx, cy), radius, (10, 200, 30), -1)
        viz.filled_circle(got, (cx, cy), radius, (10, 200, 30))
        np.testing.assert_array_equal(got, want, err_msg=f"{cx}, {cy}")


@pytest.mark.parametrize("radius", [1, 2, 4, 5, 8])
def test_draw_points_equals_jax(radius):
    rng = np.random.RandomState(radius)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    pts = rng.randint(-10, 74, (40, 2)).astype(np.int32)
    color = viz.label_color(radius)
    assert color == jax_viz.label_color(radius)
    got = viz.draw_points(img.copy(), pts, color, radius=radius)
    want = jax_viz.draw_points(img.copy(), pts, color, radius=radius)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def test_project_and_draw_pose_mesh_equal_jax():
    from pvn3d_tpu_torch.config import INTRINSICS
    rng = np.random.RandomState(0)
    k = INTRINSICS["linemod"]
    mesh = rng.uniform(-0.05, 0.05, (500, 3)).astype(np.float32)
    for i in range(4):
        q = rng.randn(3) * 0.3
        c, s = np.cos(q), np.sin(q)
        rot = (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
               @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]]))
        pose = np.concatenate([rot, [[0.05 * i], [-0.02], [0.7]]],
                              1).astype(np.float32)
        cam = mesh @ pose[:, :3].T + pose[:, 3]
        np.testing.assert_array_equal(viz.project_points_np(cam, k),
                                      jax_viz.project_points_np(cam, k))
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        got = viz.draw_pose_mesh(img.copy(), mesh, pose, k, cls_id=i + 1)
        want = jax_viz.draw_pose_mesh(img.copy(), mesh, pose, k,
                                      cls_id=i + 1)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def _first_items(n):
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()][:n]


def _trees(root):
    ycb = make_fake_ycb(root, h=120, w=160, cls_ids=(1, 2),
                        items=_first_items(2), mesh_ids=range(1, 22))
    lm = make_fake_linemod(root, n_frames=2, h=260, w=360)
    return {"ycb": ycb, "linemod": lm}


def _overlay_weights(model):
    """Random weights whose poses land in the image: the vote heads'
    outputs scaled by 1e-2 (offsets of centimetres, not metres) and class
    1's seg logit raised, so class 1 is present and its pose sits near its
    cloud."""
    variables, _, _ = jax_and_port_weights(model, seed=7)
    params = variables["params"]
    for head in ("kp_head", "ctr_head"):
        for leaf in ("kernel", "bias"):
            params[head]["out"][leaf] = params[head]["out"][leaf] * 1e-2
    bias = np.array(params["seg_head"]["out"]["bias"])
    bias[1] += 50.0
    params["seg_head"]["out"]["bias"] = bias
    return variables


@pytest.mark.parametrize("dataset", ["ycb", "linemod"])
def test_demo_matches_jax(dataset, tmp_path, monkeypatch,
                          jax_pallas_winner):
    from pvn3d_tpu.apps import demo as jax_demo
    from pvn3d_tpu.train import checkpoint as jax_ckpt
    from pvn3d_tpu.train import state as jax_state_mod
    from pvn3d_tpu.utils import cache as jax_cache

    root = _trees(str(tmp_path))[dataset]
    # JAX's apps build frames at FrameSpec's default budget (12288
    # points) whatever the model; the port's at the model's.
    model = dataclasses.replace(small_model_cfg(), n_sample_points=12288)
    if dataset == "linemod":
        model = dataclasses.replace(model, n_classes=2)
        jcfg = dataclasses.replace(jax_config.Config.linemod("ape"),
                                   model=model)
    else:
        jcfg = jax_config.Config(model=model)
    variables = _overlay_weights(model)
    port_sd = from_jax_variables(variables)

    # The port's checkpoint holds the weights JAX's restore hands over.
    pcfg = to_port(jcfg)
    monkeypatch.setattr(train, "base_config", lambda d, c: pcfg)
    state = create_train_state(pcfg, 0, "cpu")
    state.model.load_state_dict(port_sd)
    run = str(tmp_path / "run")
    CheckpointManager(run).save(1, state)

    # JAX's state is the variables themselves (its eager init compiles
    # for a minute on the CPU and its values are replaced at once).
    def jax_state(cfg, rng, example):
        return (types.SimpleNamespace(**variables),
                JaxPVN3D(cfg=cfg.model, train=True), None)

    class Restore:
        def __init__(self, directory):
            pass

        def restore(self, state):
            return state
    monkeypatch.setattr(jax_state_mod, "create_train_state", jax_state)
    monkeypatch.setattr(jax_ckpt, "CheckpointManager", Restore)
    monkeypatch.setattr(jax_cache, "enable_compilation_cache",
                        lambda *a: None)
    monkeypatch.setattr(jax_frame, "normals_from_depth_map",
                        functools.partial(jax_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(port_frame, "normals_from_depth_map",
                        functools.partial(port_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(jax_config.Config, "ycb", staticmethod(lambda: jcfg))
    monkeypatch.setattr(jax_config.Config, "linemod",
                        staticmethod(lambda cls: jcfg))
    written = {}
    monkeypatch.setattr(cv2, "imwrite",
                        lambda path, img: written.setdefault(
                            os.path.basename(path), img.copy()) is None)

    argv = ["--dataset", dataset, "--cls", "ape", "--data_root", root,
            "--checkpoint_dir", run, "--n_frames", "2", "--workers", "0",
            "--no_fill_depth"]
    jax_demo.main(argv + ["--out_dir", str(tmp_path / "jax")])
    paths = demo.main(argv + ["--out_dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["0.png", "1.png"]
    assert sorted(written) == ["0.jpg", "1.jpg"]
    drawn = 0
    for i, path in enumerate(paths):
        got = read_png(path)
        want = written[f"{i}.jpg"][..., ::-1]
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (got == want).all(-1).mean() >= 0.999
    # overlay pixels: the written image against the frame as read
    frames = {"ycb": lambda i: read_png(os.path.join(
        root, _first_items(2)[i] + "-color.png")),
        "linemod": lambda i: read_png(os.path.join(
            root, "data", "01", "rgb", f"{i:04d}.png"))}[dataset]
    for i, path in enumerate(paths):
        drawn += int((read_png(path) != frames(i)).any(-1).sum())
    assert drawn > 0


def test_demo_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--data_root", str(tmp_path), "--checkpoint_dir",
                   str(tmp_path)])
