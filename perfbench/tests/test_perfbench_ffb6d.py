"""The FFB6D cell on the CPU at a small size (a 64x80 frame, 1280 points,
published widths): its driver run end to end comes out correct, reads its
spans, and comes out not correct with the neighbour index or the answer
broken underneath; its configuration file holds the port's FFB6D config;
its work counts; and its reference loads nothing of the port."""
import dataclasses
import json
import time
import types

import pytest
import torch

from perfbench import spec, work_ffb6d
from perfbench.tests.test_perfbench_checks import _loaded
from perfbench import run as runner

CELL = "ffb6d-ycb-serve-raw"


def tiny_cell() -> dict:
    from pvn3d_tpu_torch.config import small_ffb6d_config
    c = spec.cell(CELL)
    model = json.loads(json.dumps(dataclasses.asdict(small_ffb6d_config())))
    model["compute_dtype"] = c["config"]["program"]["model"]["compute_dtype"]
    c["config"] = dict(c["config"], program=dict(c["config"]["program"],
                                                 model=model))
    c["traffic"] = dict(c["traffic"], pool=3, warmup=1, traced=2,
                        check_frames=2)
    return c


def _run(trace=0, seed=2 ** 31 + 11):
    c = tiny_cell()
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.5,
                                 trace=trace, rank=0, port=0)
    return spec.driver(c["traffic"]["driver"]).run(
        c, args, time.perf_counter(), torch.device("cpu"))


def test_ffb6d_serve_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["index_diff"]["value"] == 0.0
    assert set(out["metrics"]) == {"serve_p50_ms", "serve_p95_ms",
                                   "setup_s"}


def test_ffb6d_traced_run_reads_its_spans():
    out = _run(trace=1)
    assert out["correct"], out["checks"]
    for m in ("frame_build_ms.serve", "image_branch_ms.serve",
              "point_branch_ms.serve", "heads_ms.serve",
              "pose_stage_ms.serve", "mfu.serve", "neighbour_index_ms.serve",
              "fusion_ms.serve", "host_reads.serve"):
        assert out["metrics"][m] > 0, m
    # No device time on the CPU.
    for m in ("knn_roofline.serve", "kernel_roofline.serve",
              "neighbour_index_device_ms.serve"):
        assert m not in out["metrics"]


def test_a_wrong_neighbour_is_not_correct(monkeypatch):
    """The search answers one row of a request's 22 searches wrong (the
    first search's first row): ``index_diff`` reads it and the run is not
    correct."""
    from pvn3d_tpu_torch.data import ffb6d_index
    real = ffb6d_index.knn
    calls = [0]

    def wrong(query, cand, k):
        out = real(query, cand, k)
        if calls[0] % 22 == 0:
            out = out.clone()
            out[:, 0] = (out[:, 0] + 1) % cand.shape[1]
        calls[0] += 1
        return out
    monkeypatch.setattr(ffb6d_index, "knn", wrong)
    out = _run()
    assert not out["correct"]
    rows = sum(q.shape[1] for _, q, _, _ in _searches(small=True))
    assert out["checks"]["index_diff"]["value"] == pytest.approx(1 / rows)


def _searches(small: bool):
    """The 22 searches of the cell's configuration (or the small one) on
    a frame of zeros: their shapes."""
    from pvn3d_tpu_torch.config import small_ffb6d_config
    from pvn3d_tpu_torch.data.ffb6d_index import searches
    from perfbench.drivers import serve_raw_ffb6d
    mc = (small_ffb6d_config() if small else serve_raw_ffb6d.program_config(
        spec.cell(CELL)["config"]).model)
    todo, _, _ = searches(torch.zeros(1, mc.n_sample_points, 3), torch.zeros(
        1, mc.image_height, mc.image_width, 3), mc)
    return todo


def test_one_wrong_row_at_the_cells_size_is_not_correct():
    """At the cell's own size (~249,000 rows over the 22 searches) one
    wrong row is past the ``index_diff`` limit."""
    from perfbench.drivers import common
    todo = _searches(small=False)
    rows = sum(q.shape[1] for _, q, _, _ in todo)
    assert len(todo) == 22 and rows == 248850
    _, ok = common.checks({"index_diff": 1 / rows}, spec.cell(CELL)["limits"])
    assert not ok


def test_the_sample_in_ascending_order_is_not_correct(monkeypatch):
    """PVN3D's ascending sample in FFB6D's place: ``choose_diff``."""
    from pvn3d_tpu_torch.inference import pipeline
    real = pipeline.build_inference_batch_device

    def ascending(*a, **kw):
        kw["priority_order"] = False
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "build_inference_batch_device", ascending)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["choose_diff"]["value"] > 0


def test_configuration_file_holds_the_ports_ffb6d_config():
    from pvn3d_tpu_torch.config import ffb6d_config
    from perfbench.drivers import serve_raw_ffb6d
    c = spec.cell(CELL)["config"]
    assert serve_raw_ffb6d.program_config(c) == ffb6d_config()
    assert c["reduced"] == [] and len(c["assumed"]) >= 5
    ycb = spec.cell("ycb-serve-raw")["config"]
    for key in ("mesh_kps", "radii", "camera_k", "cam_scale", "fill_depth",
                "refine_mask"):
        assert c[key] == ycb[key]
    mix = spec.cell(CELL)["traffic"]
    same = spec.cell("ycb-serve-raw")["traffic"]
    assert {k: v for k, v in mix.items() if k not in ("driver", "about")} \
        == {k: v for k, v in same.items() if k not in ("driver", "about")}


def test_work_counts():
    model = spec.cell(CELL)["config"]["program"]["model"]
    total = work_ffb6d.forward_flops(model)
    assert total == pytest.approx(
        work_ffb6d.image_flops(model) + work_ffb6d.point_flops(model)
        + work_ffb6d.fusion_flops(model) + work_ffb6d.heads_flops(model))
    # The dense image tail dominates: ResNet34 + PSP + the upsamples.
    assert 3.5e11 < total < 4.5e11
    n_bytes, flops = work_ffb6d.knn_work((1, 76800, 3), (1, 3200, 3), 1)
    assert flops == 76800 * 3200 * 8
    assert n_bytes == 76800 * 12 + 3200 * 12 + 76800 * 4


def test_the_ffb6d_reference_loads_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.ffb6d, "
                   "perfbench.reference.knn")
    assert not mods & {"pvn3d_tpu_torch", *runner.FORBIDDEN}


def test_nothing_the_ffb6d_driver_loads_is_jax():
    mods = _loaded("import perfbench.drivers.serve_raw_ffb6d, "
                   "perfbench.work_ffb6d")
    assert "pvn3d_tpu_torch" in mods
    assert not mods & set(runner.FORBIDDEN)


@pytest.mark.card
def test_ffb6d_serve_readings(card):
    """On the card at the cell's size: the program's numbers and the
    control's (the reference one precision below) for each seed, as
    ``test_perfbench_card.py`` reads the other cells; the control comes
    out not correct on every seed it reads, the program correct."""
    from perfbench.drivers import serve_raw_ffb6d
    from perfbench.tests.test_perfbench_card import (CONTROL_SEEDS, SEEDS,
                                                     _emit)
    cell = spec.cell(CELL)
    wrong = []
    for i, seed in enumerate(SEEDS):
        srv = serve_raw_ffb6d.Server(cell, seed, card)
        srv.make_step(False)
        for _ in range(cell["traffic"]["warmup"] + 2 * cell["traffic"]
                       ["check_frames"]):
            srv.request(srv.next_frame())
        srv.free_program()
        checks, ok = srv.check(seed, cell["limits"])
        _emit({"cell": CELL, "seed": seed, "who": "program", "correct": ok,
               "checks": checks})
        wrong += [] if ok else [(seed, "program")]
        if i < CONTROL_SEEDS:
            checks, ok = srv.check(seed, cell["limits"], lambda j: (
                serve_raw_ffb6d.control(srv.config, srv.sd, srv.frames[j],
                                        srv.prio[j:j + 1], card)))
            _emit({"cell": CELL, "seed": seed, "who": "control",
                   "correct": ok, "checks": checks})
            wrong += [(seed, "control")] if ok else []
        del srv
        torch.cuda.empty_cache()
    assert not wrong, wrong
