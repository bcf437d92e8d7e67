"""The port's procedural world and its accuracy tool: ``SyntheticWorld``
and ``sample_batch`` bit-identical to the JAX package's for the same seeds
and data stream, ``collate``, and ``tools/synthetic_e2e.py`` on the CPU at
its tiny config (training, scoring with and without ICP, a checkpoint
round trip)."""
import json
import math

import numpy as np
import pytest

from pvn3d_tpu.data import frame as jax_frame
from pvn3d_tpu.data.synthetic_world import SyntheticWorld as JaxWorld

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.data import frame  # noqa: E402
from pvn3d_tpu_torch.data.synthetic_world import SyntheticWorld  # noqa: E402
from pvn3d_tpu_torch.tools import synthetic_e2e  # noqa: E402


@pytest.mark.parametrize("seed", [0, 3])
def test_world_meshes_and_keypoints_identical(seed):
    got = SyntheticWorld(n_classes=5, n_keypoints=8, seed=seed)
    want = JaxWorld(n_classes=5, n_keypoints=8, seed=seed)
    for name in ("stacked_kps", "stacked_pts", "stacked_valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(got.mesh_pts) == len(want.mesh_pts) == 5


@pytest.mark.parametrize("stream", [0, 1])
def test_sample_batch_identical(stream):
    """Two batches in a row from one stream: every field bit for bit, the
    same dtypes, and the stream left where JAX's leaves it."""
    got_w, want_w = SyntheticWorld(seed=0), JaxWorld(seed=0)
    got_rng = np.random.RandomState(stream)
    want_rng = np.random.RandomState(stream)
    kw = dict(n_points=600, height=24, width=32)
    for _ in range(2):
        got = got_w.sample_batch(got_rng, 3, **kw)
        want = want_w.sample_batch(want_rng, 3, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)
    assert got["pointcloud"].shape == (3, 600, 9)


def test_collate_matches_jax():
    rng = np.random.RandomState(0)
    samples = [{"a": rng.rand(4, 3).astype(np.float32),
                "b": rng.randint(0, 9, 5).astype(np.int32)}
               for _ in range(3)]
    got, want = frame.collate(samples), jax_frame.collate(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


_KEYS = {"metric", "value", "add_auc", "adds_auc", "eval_seg_acc", "steps"}
_ICP_KEYS = {"add_s_auc", "add_auc", "adds_auc", "delta_add_auc",
             "delta_adds_auc", "scene_mode"}


def _finite(rec):
    return all(math.isfinite(v) for k, v in rec.items()
               if k not in ("metric", "scene_mode", "icp"))


def test_tool_tiny_cpu_trains_scores_and_round_trips(tmp_path, capsys):
    """Two training steps at the tiny config on the CPU, scored without
    ICP and saved; then the checkpoint loaded (the data stream skipped
    past the same training batches) and scored again with ICP: the JAX
    tool's keys, finite values, the same scores without ICP both times,
    and an ICP block in sampled scene mode."""
    ckpt = str(tmp_path / "tiny.pt")
    common = ["--tiny", "--device", "cpu", "--steps", "2", "--batch", "2",
              "--eval_frames", "2"]
    trained = synthetic_e2e.main(common + ["--save_ckpt", ckpt])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == trained
    assert set(trained) == _KEYS and trained["steps"] == 2
    assert trained["metric"] == "synthetic_e2e_add_s_auc"
    assert _finite(trained)
    assert any(line.startswith("trained 2 steps") for line in out)

    loaded = synthetic_e2e.main(common + ["--load_ckpt", ckpt, "--icp"])
    assert set(loaded) == _KEYS | {"icp"}
    assert set(loaded["icp"]) == _ICP_KEYS
    assert loaded["icp"]["scene_mode"] == "sampled"
    assert _finite(loaded) and _finite(loaded["icp"])
    assert {k: loaded[k] for k in _KEYS} == trained
    assert 0.0 <= loaded["eval_seg_acc"] <= 1.0
