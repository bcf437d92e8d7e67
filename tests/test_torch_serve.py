"""The port's serving app (``apps/serve.py``) on the CPU at the small
configuration, and the reference checkpoint loader it uses
(``utils/weights.py::load_torch_state_dict``) against the JAX package's
reference weights."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.apps import serve  # noqa: E402
from pvn3d_tpu_torch.config import Config, small_model_config  # noqa: E402
from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           load_torch_state_dict)
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)


def test_load_torch_state_dict(tmp_path):
    """A reference checkpoint (tar layout, DataParallel prefixes) loads
    into the port's model with strict key and shape checks."""
    cfg = small_model_cfg()
    _, _, sd = jax_and_port_weights(cfg, seed=22)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 3, "model_state": {f"module.{k}": v
                                            for k, v in sd.items()}}, path)
    got = load_torch_state_dict(path)
    assert sorted(got) == sorted(sd)
    model = PVN3D(to_port(cfg))
    model.load_state_dict(got, strict=True)
    state = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(state[k], torch.as_tensor(v)), k
    bad = dict(got)
    bad.pop(next(iter(bad)))
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(bad, strict=True)


def small_config():
    return Config(model=small_model_config())


def test_serve_on_the_cpu_writes_records(tmp_path, capsys):
    out = str(tmp_path / "poses.jsonl")
    rec = serve.main(["--device", "cpu", "--frames", "2", "--warmup", "1",
                      "--out", out], small_config())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == rec
    assert rec["frames"] == 2 and rec["device"] == "cpu"
    assert rec["value"] > 0
    lat = rec["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    with open(out) as f:
        lines = [json.loads(x) for x in f]
    assert [x["frame"] for x in lines] == [0, 1]
    for x in lines:
        assert len(x["poses"]) == len(x["present"])
        assert np.isfinite(np.asarray(x["poses"], np.float64)).all()



def test_serve_writes_a_trace_naming_the_port_spans(tmp_path):
    """``--trace_dir``: one Chrome trace of ``--trace_frames`` frames after
    the timed ones, holding a ``pvn3d.request#<n>`` per traced frame."""
    logdir = tmp_path / "trace"
    serve.main(["--device", "cpu", "--frames", "1", "--warmup", "0",
                "--trace_dir", str(logdir), "--trace_frames", "1"],
               small_config())
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sum(n.startswith("pvn3d.request#") for n in names) == 1
    assert "pvn3d.pose_stage" in names

def test_serve_loads_a_reference_checkpoint(tmp_path):
    path = str(tmp_path / "ref.pth.tar")
    sd = build_model(small_model_config(), 5).state_dict()
    torch.save({"model_state": {f"module.{k}": v for k, v in sd.items()}},
               path)
    rec = serve.main(["--device", "cpu", "--frames", "1", "--warmup", "0",
                      "--torch_ckpt", path, "--no_fill_depth"],
                     small_config())
    assert rec["frames"] == 1
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.main(["--device", "cpu", "--frames", "1",
                    "--checkpoint_dir", str(tmp_path / "empty")],
                   small_config())


def test_serve_restores_a_training_checkpoint(tmp_path):
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    cfg = small_config()
    state = create_train_state(cfg, seed=3, device="cpu")
    CheckpointManager(str(tmp_path)).save(7, state)
    out = str(tmp_path / "poses.jsonl")
    rec = serve.main(["--device", "cpu", "--frames", "1", "--warmup", "0",
                      "--checkpoint_dir", str(tmp_path), "--out", out,
                      "--no_fill_depth"], cfg)
    assert rec["frames"] == 1
    with open(out) as f:
        assert json.loads(f.readline())["frame"] == 0


def test_serve_reads_png_pairs(tmp_path):
    """``--source dir``: <stem>-color.png / <stem>-depth.png pairs, depth
    in ``--cam_scale`` units per metre (16-bit PNG), cycled over."""
    Image = pytest.importorskip("PIL.Image")
    cfg = small_config()
    h, w = cfg.model.image_height, cfg.model.image_width
    for i in range(2):
        rgb, depth, _ = synth_sensor_frame(h, w, seed=i)
        Image.fromarray(rgb[0].astype(np.uint8)).save(
            str(tmp_path / f"{i:06d}-color.png"))
        Image.fromarray((depth[0] * 10000).astype(np.uint16)).save(
            str(tmp_path / f"{i:06d}-depth.png"))
    out = str(tmp_path / "poses.jsonl")
    rec = serve.main(["--device", "cpu", "--source", "dir", "--frame_dir",
                      str(tmp_path), "--frames", "3", "--warmup", "0",
                      "--out", out], cfg)
    assert rec["frames"] == 3
    with open(out) as f:
        assert [json.loads(x)["frame"] for x in f] == [0, 1, 2]
    with pytest.raises(SystemExit, match="no \\*-color.png"):
        serve.main(["--device", "cpu", "--source", "dir", "--frame_dir",
                    str(tmp_path / "none"), "--frames", "1"], cfg)


def test_serve_png_frames_pose_as_their_arrays(tmp_path):
    """Two frames PIL wrote, served from ``--source dir`` (read by
    ``data/png.py``), give the poses of the same arrays passed to the
    raw step with the app's weights and per-frame generators."""
    from pvn3d_tpu_torch.inference.pipeline import make_raw_inference_step
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    Image = pytest.importorskip("PIL.Image")
    cfg = small_config()
    h, w = cfg.model.image_height, cfg.model.image_width
    frames = []
    for i in range(2):
        rgb, depth, _ = synth_sensor_frame(h, w, seed=i + 3)
        rgb8, depth16 = rgb[0].astype(np.uint8), (depth[0] * 10000).astype(
            np.uint16)
        Image.fromarray(rgb8).save(str(tmp_path / f"{i:06d}-color.png"))
        Image.fromarray(depth16).save(str(tmp_path / f"{i:06d}-depth.png"))
        frames.append((rgb8.astype(np.float32),
                       depth16.astype(np.float32) / 10000.0))
    out = str(tmp_path / "poses.jsonl")
    serve.main(["--device", "cpu", "--source", "dir", "--frame_dir",
                str(tmp_path), "--frames", "2", "--warmup", "0", "--out",
                out], cfg)
    with open(out) as f:
        served = [json.loads(x) for x in f]
    cpu = torch.device("cpu")
    step = make_raw_inference_step(
        cfg, build_model(cfg.model, 0), stacked_mesh_kps(cfg.model.n_classes),
        stacked_class_radii(), device=cpu)
    for i, (rgb, depth) in enumerate(frames):
        want = step({"rgb": rgb[None], "depth": depth[None],
                     "cam_k": serve._YCB_K[None]},
                    generator=serve.frame_generator(i, cpu))
        present = want["present"][0].numpy()
        assert served[i]["present"] == present.nonzero()[0].tolist()
        np.testing.assert_array_equal(
            np.asarray(served[i]["poses"], np.float32).reshape(-1, 3, 4),
            want["poses"][0].numpy()[present > 0])


def test_serve_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--frames", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--device", "cuda", "--frames", "1"])


def test_frame_generators_are_per_frame():
    dev = torch.device("cpu")
    a = torch.rand(4, generator=serve.frame_generator(0, dev))
    b = torch.rand(4, generator=serve.frame_generator(0, dev))
    c = torch.rand(4, generator=serve.frame_generator(1, dev))
    assert torch.equal(a, b) and not torch.equal(a, c)
