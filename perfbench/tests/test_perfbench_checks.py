"""A run's ``correct`` on the CPU at a small size: each driver run end to
end, skipping only the look for a card, comes out correct, and comes out
not correct with the timed path broken underneath in each way the cell
can break (an answer altered where it is produced; a step that leaves the
state unchanged; half the batch left out).  And the import rules: nothing
the harness loads is JAX or the JAX package, and the reference loads
nothing of the port."""
import dataclasses
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from perfbench import run as runner
from perfbench import spec


def tiny_cell(workload: str) -> dict:
    """``workload`` at the port's small check size: 64x80 frames, 2048
    points, narrow heads; a short pool and check.  Serving computes in
    bf16 as configured; training in float32, since the limits of a
    three-step training check are the full-size batch's and a batch of 4
    in bf16 reads wider."""
    from pvn3d_tpu_torch.config import small_model_config
    c = spec.cell(workload)
    model = json.loads(json.dumps(dataclasses.asdict(small_model_config())))
    model["n_classes"] = c["config"]["program"]["model"]["n_classes"]
    model["compute_dtype"] = c["config"]["program"]["model"]["compute_dtype"]
    c["config"] = dict(c["config"], program=dict(c["config"]["program"],
                                                 model=model))
    if c["traffic"]["driver"] == "serve_raw":
        c["traffic"] = dict(c["traffic"], pool=3, warmup=1, traced=2,
                            check_frames=2)
    else:
        model["compute_dtype"] = "float32"
        c["traffic"] = dict(c["traffic"], batch=4, world=1, traced=1)
    return c


def _run(workload, trace=0, seed=2 ** 31 + 11):
    c = tiny_cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.5,
                                 trace=trace, rank=0, port=0)
    return spec.driver(c["traffic"]["driver"]).run(
        c, args, time.perf_counter(), torch.device("cpu"))


def test_serve_run_is_correct():
    out = _run("ycb-serve-raw")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"serve_p50_ms", "serve_p95_ms",
                                   "setup_s"}


def test_serve_traced_run_reads_its_spans():
    out = _run("lm-serve-raw", trace=1)
    assert out["correct"], out["checks"]
    for m in ("frame_build_ms.serve", "image_branch_ms.serve",
              "point_branch_ms.serve", "heads_ms.serve",
              "pose_stage_ms.serve", "mfu.serve"):
        assert out["metrics"][m] > 0
    assert "kernel_roofline.serve" not in out["metrics"]   # no device time


def test_serve_answer_altered_where_produced_is_not_correct(monkeypatch):
    from pvn3d_tpu_torch.inference import pipeline, pose
    real = pose.cal_frame_poses

    def altered(*a, **kw):
        f = real(*a, **kw)
        present = f.present.clone()
        present[1] = ~present[1]
        return pose.FramePoses(f.poses + 0.01, present, f.kps)
    monkeypatch.setattr(pipeline, "cal_frame_poses", altered)
    out = _run("ycb-serve-raw")
    assert not out["correct"]
    assert out["checks"]["present_diff"]["value"] > 0


@pytest.mark.parametrize("workload,same", [("ycb-serve-raw", True),
                                             ("lm-serve-raw", False)])
def test_a_work_seed_serves_the_same_work_in_another_order(workload, same):
    """With the mix's ``work_seed`` two seeds serve the same weights, frames
    and priorities in orders of their own; without it the work is the
    seed's."""
    from perfbench.drivers import serve_raw
    c = tiny_cell(workload)
    assert ("work_seed" in c["traffic"]) == same
    a, b = (serve_raw.Server(c, s, torch.device("cpu"))
            for s in (2 ** 31 + 11, 2 ** 31 + 12))
    frames = all((fa["rgb"] == fb["rgb"]).all()
                 and (fa["depth"] == fb["depth"]).all()
                 for fa, fb in zip(a.frames, b.frames))
    weights = all(torch.equal(a.sd[k], b.sd[k]) for k in a.sd)
    assert frames == weights == torch.equal(a.prio, b.prio) == same
    assert ([a.next_frame() for _ in range(16)]
            != [b.next_frame() for _ in range(16)])


def test_train_run_is_correct():
    out = _run("ycb-train-b24")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_frames_per_s", "setup_s"}


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self: None)
    out = _run("ycb-train-b24")
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    from perfbench.drivers import train
    real = train.Trainer.__init__

    def half(self, *a, **kw):
        real(self, *a, **kw)
        self.local = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                      for b in self.local]
    monkeypatch.setattr(train.Trainer, "__init__", half)
    out = _run("ycb-train-b24")
    assert not out["correct"]


def _loaded(code: str) -> dict:
    """Top-level module names loaded by ``code`` in a fresh process."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=spec.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    mods = _loaded(
        "import perfbench.run, perfbench.drivers.serve_raw, "
        "perfbench.drivers.train, perfbench.reference.model, "
        "perfbench.reference.frame, perfbench.reference.pose\n"
        "import pvn3d_tpu_torch.inference.pipeline, "
        "pvn3d_tpu_torch.train.step, pvn3d_tpu_torch.train.state, "
        "pvn3d_tpu_torch.parallel")
    assert "pvn3d_tpu_torch" in mods
    assert not mods & set(runner.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.model, "
                   "perfbench.reference.frame, perfbench.reference.pose, "
                   "perfbench.reference.ops")
    assert not mods & {"pvn3d_tpu_torch", *runner.FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pvn3d_tpu_torch_extra",
                        types.ModuleType("x"))
    assert "pvn3d_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pvn3d_tpu.ops", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["pvn3d_tpu"]


def _dp_rank(rank, world, store, fault, queue):
    """One rank of a data-parallel training run on the CPU (gloo)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from perfbench.drivers import train
    from pvn3d_tpu_torch.parallel import initialize_distributed, make_mesh
    if fault:
        import pvn3d_tpu_torch.train.step as step
        step.all_reduce_gradients = lambda mesh, params: None
    c = tiny_cell("ycb-train-b24")
    c["traffic"] = dict(c["traffic"], world=world)
    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    args = types.SimpleNamespace(workload="ycb-train-b24", seed=2 ** 31 + 3,
                                 seconds=0.5, trace=0, rank=rank, port=0)
    out = train._run(c, args, time.perf_counter(), torch.device("cpu"),
                     make_mesh(device="cpu"))
    if rank == 0:
        queue.put(out)
    dist.destroy_process_group()


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "no_exchange"])
def test_data_parallel_run_and_the_exchange_left_out(tmp_path, fault):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_dp_rank, args=(r, 2, tmp_path / "store",
                                                 fault, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    out = queue.get(timeout=600)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive()
    assert out["correct"] != fault, out["checks"]
