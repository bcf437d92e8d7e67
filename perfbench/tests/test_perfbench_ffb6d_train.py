"""The FFB6D training cell on the CPU at a small size (a 64x80 frame, 1280
points, published widths, float32, batch 4): its driver run end to end
comes out correct and reads its spans, and comes out not correct with
half the batch left out, the state left unchanged, a gather's backward
that drops rows, a wrong neighbour, or the float8 control in the
program's place; its configuration file holds the port's FFB6D config
at the published global batch; its work counts; its reference loads
nothing of the port.  And, on the card, the readings its limits are set
from."""
import dataclasses
import json
import time
import types

import pytest
import torch

from perfbench import spec, work, work_ffb6d
from perfbench import run as runner
from perfbench.drivers import common, train, train_ffb6d
from perfbench.tests.test_perfbench_checks import _loaded

CELL = "ffb6d-ycb-train-b24"


def tiny_cell() -> dict:
    from pvn3d_tpu_torch.config import small_ffb6d_config
    c = spec.cell(CELL)
    model = json.loads(json.dumps(dataclasses.asdict(small_ffb6d_config())))
    c["config"] = dict(c["config"], program=dict(c["config"]["program"],
                                                 model=model))
    # Batch 4: half of it reads a loss gap of ~0.5, as at the cell's 24.
    c["traffic"] = dict(c["traffic"], batch=4, traced=1)
    return c


def _run(trace=0, seed=2 ** 31 + 11):
    c = tiny_cell()
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.5,
                                 trace=trace, rank=0, port=0)
    return train_ffb6d.run(c, args, time.perf_counter(), torch.device("cpu"))


def test_ffb6d_train_run_is_correct(capsys):
    """Correct; the gradient-norm gap, which the cell's limits leave out,
    is read on standard error and compared with nothing."""
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert set(out["checks"]) == {"loss_gap", "update_gap", "index_diff",
                                  "frozen_bn_out_rel", "frozen_bn_grad_rel"}
    assert out["checks"]["index_diff"]["value"] == 0
    # float32 on both sides, BN frozen: nothing amplifies the rounding.
    for k in ("frozen_bn_out_rel", "frozen_bn_grad_rel"):
        assert out["checks"][k]["value"] < 1e-4, k
    assert "perfbench: grad_gap " in capsys.readouterr().err


def test_ffb6d_train_traced_run_reads_its_spans():
    out = _run(trace=1)
    assert out["correct"], out["checks"]
    for m in ("forward_ms.train", "optimizer_ms.train", "mfu.train"):
        assert out["metrics"][m] > 0, m
    # No device time on the CPU.
    for m in ("neighbour_index_device_ms.train", "fusion_device_ms.train",
              "gather_backward_device_ms.train", "knn_roofline.train",
              "backward_device_ms.train"):
        assert m not in out["metrics"]


def test_half_the_batch_is_not_correct(monkeypatch):
    real = train_ffb6d.Trainer.__init__

    def half(self, *a, **kw):
        real(self, *a, **kw)
        self.local = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                      for b in self.local]
    monkeypatch.setattr(train_ffb6d.Trainer, "__init__", half)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]


def test_state_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self: None)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_a_gather_backward_that_drops_rows_is_not_correct(monkeypatch):
    """The gathers' backward sums only the first half of the gathered rows'
    gradients into their sources."""
    from pvn3d_tpu_torch.models import randla

    def dropping(ctx, grad):
        (rows,) = ctx.saved_tensors
        b, n, c = ctx.shape
        keep = rows.numel() // 2
        table = torch.zeros((b * n, c), dtype=torch.float32)
        table.index_add_(0, rows[:keep], grad.reshape(-1, c)[:keep].float())
        return table.to(grad.dtype).reshape(b, n, c), None
    monkeypatch.setattr(randla.GatherRows, "backward", staticmethod(dropping))
    out = _run()
    assert not out["correct"]
    assert out["checks"]["frozen_bn_grad_rel"]["value"] > out["checks"][
        "frozen_bn_grad_rel"]["limit"]


def test_a_wrong_neighbour_is_not_correct(monkeypatch):
    """The index the program builds gives one point of one frame another
    nearest pixel in one search: ``index_diff`` reads above its 0."""
    from pvn3d_tpu_torch.models import ffb6d

    real = ffb6d.build_index

    def wrong(*a, **kw):
        idx = real(*a, **kw)
        p2r = idx["p2r_up"][-1].clone()
        p2r[0, 0] = (p2r[0, 0] + 1) % int(p2r.max() + 1)
        return dict(idx, p2r_up=idx["p2r_up"][:-1] + [p2r])
    monkeypatch.setattr(ffb6d, "build_index", wrong)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["index_diff"]["value"] > 0


def test_the_control_in_the_programs_place_is_not_correct():
    """The float8 reference in the program's place, through ``check``: the
    frozen-BN numbers fail it, each by more than twice its limit (its
    index is the reference's own)."""
    c = tiny_cell()
    args = types.SimpleNamespace(workload=CELL, seed=2 ** 31 + 11, rank=0)
    cpu = torch.device("cpu")
    tr = train_ffb6d.Trainer(c, args, cpu)
    _, draws = tr.frozen_bn(tr.pool[0])
    rec = train.DropoutRecord()
    rec.install()
    tr.first_steps()
    rec.remove()
    sides = [train_ffb6d.reference_side(c["config"], tr.sd, tr.names,
                                        tr.pool, rec.draws, draws, cpu, lowp)
             for lowp in (True, False)]
    checks, ok = train_ffb6d.check(*sides, c["limits"])
    assert not ok
    for k in ("frozen_bn_out_rel", "frozen_bn_grad_rel"):
        assert checks[k]["value"] > 2 * checks[k]["limit"], (k, checks)


def test_frozen_output_gap_is_over_each_heads_scale():
    """Each head's gap is read over |W| |h| / sqrt(fan-in) of its last
    layer on the reference's hidden layer: a head whose outputs cancel to
    a tenth of that scale reads the same error as the others."""
    g = torch.Generator().manual_seed(0)
    model = {"seg_head": [4], "kp_head": [4, 4], "ctr_head": [4]}
    shapes = {"seg_logits": 3, "kp_offsets": 6, "ctr_offsets": 3}
    sd, out, prog, want = {}, {}, {}, {}
    for k, (short, layer, widths) in train_ffb6d.HEADS.items():
        w = torch.randn(shapes[k], 4, 1, generator=g)
        h = torch.randn(2, 7, 4, generator=g)
        sd[f"{layer}.{len(model[widths])}.conv.weight"] = w
        out[f"{short}_hidden"] = h
        want[k] = (float((w ** 2).sum()) * float((h ** 2).sum()) / 4) ** 0.5
    scales = train_ffb6d.head_scales(model, sd, out)
    assert scales == pytest.approx(want)
    ref = {k: torch.randn(2, 7, shapes[k], generator=g) for k in shapes}
    ref["ctr_offsets"] *= 0.1 * scales["ctr_offsets"] / float(
        ref["ctr_offsets"].norm())
    for k in shapes:
        err = torch.randn(ref[k].shape, generator=g)
        prog[k] = ref[k] + 0.01 * scales[k] * err / float(err.norm())
    grads = {f"leaf{i}": torch.full((3,), float(i + 1)) for i in range(3)}
    gaps = train_ffb6d.frozen_gaps((prog, grads), (ref, grads, scales))
    assert gaps["frozen_bn_out_rel"] == pytest.approx(0.01, rel=1e-5)
    assert gaps["frozen_bn_grad_rel"] == 0.0


def test_configuration_file_holds_the_ports_ffb6d_config():
    from pvn3d_tpu_torch.config import ffb6d_config
    from perfbench.drivers import serve_raw_ffb6d
    c = spec.cell(CELL)
    cfg = serve_raw_ffb6d.program_config(c["config"])
    assert cfg == ffb6d_config()
    assert cfg.train.mini_batch_size == c["traffic"]["batch"] == 24
    assert c["traffic"]["world"] == 1 and c["workload"]["chips"] == 1
    assert c["config"]["reduced"] == []
    serve = spec.cell("ffb6d-ycb-serve-raw")["config"]
    assert c["config"]["program"] == serve["program"]
    assert set(serve["assumed"]) < set(c["config"]["assumed"])
    for key in ("mesh_kps", "radii", "camera_k", "cam_scale"):
        assert c["config"][key] == serve[key]
    # The training deployment is named by the script that launches it.
    assert c["config"]["source"] != serve["source"]
    assert c["config"]["source"].startswith(serve["source"] + "/")
    assert c["config"]["source"].endswith("/train_ycb.sh")


def test_work_counts():
    """MFU divides the literal graph's FLOPs a frame (the dense image tail
    at every pixel) times the batch; the k-NN work of a batch-24 search
    is 24 frames'."""
    c = spec.cell(CELL)
    model = c["config"]["program"]["model"]
    total = work_ffb6d.forward_flops(model)
    h, w = model["image_height"], model["image_width"]
    # up_3 and the second final at every one of the 480x640 pixels.
    tail = (2 * h * w * 9 * 64 * 64
            + 2 * h * w * 64 * model["cnn"]["embedding_dim"])
    assert work_ffb6d.image_flops(model) > tail
    assert 3.5e11 < total < 4.5e11
    n_bytes, flops = work_ffb6d.knn_work((24, 3200, 3), (24, 76800, 3), 16)
    one = work_ffb6d.knn_work((1, 3200, 3), (1, 76800, 3), 16)
    assert (n_bytes, flops) == (24 * one[0], 24 * one[1])
    # 100 frames/s: a step of 24 frames every 0.24 s.
    reading = types.SimpleNamespace(frames=24, flops=total, unit_s=0.24)
    reading.mfu_pct = lambda p: common.Reading.mfu_pct(reading, p)
    assert spec.reader("mfu.train")(reading) == pytest.approx(
        100 * 3 * total * 100 / work.PEAK_BF16)


def test_the_ffb6d_train_reference_loads_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.ffb6d_train")
    assert not mods & {"pvn3d_tpu_torch", *runner.FORBIDDEN}


def test_nothing_the_ffb6d_train_driver_loads_is_jax():
    mods = _loaded("import perfbench.drivers.train_ffb6d\n"
                   "import pvn3d_tpu_torch.train.step, "
                   "pvn3d_tpu_torch.models.ffb6d")
    assert "pvn3d_tpu_torch" in mods
    assert not mods & set(runner.FORBIDDEN)


@pytest.mark.card
def test_ffb6d_train_readings(card):
    """On the card at the cell's size: for each seed the program's numbers
    and, on the first seeds, the control's (the reference one precision
    below, in the program's place) and the half-batch fault's, every
    number of ``train_ffb6d.compare``, each side through ``check`` with the
    cell's limits: the program comes out correct, the fault and the
    control not."""
    from perfbench.tests.test_perfbench_card import (CONTROL_SEEDS, SEEDS,
                                                     _emit)
    cell = spec.cell(CELL)
    wrong = []
    for i, seed in enumerate(SEEDS):
        args = types.SimpleNamespace(workload=CELL, seed=seed, rank=0)
        sides = {}
        for who in ("program", "half_batch")[:1 + (i < CONTROL_SEEDS)]:
            tr = train_ffb6d.Trainer(cell, args, card)
            if who == "half_batch":
                half = cell["traffic"]["batch"] // 2
                tr.local = [{k: v[:half] for k, v in b.items()}
                            for b in tr.local]
            frozen, frozen_draws = tr.frozen_bn(tr.pool[0])
            rec = train.DropoutRecord()
            rec.install()
            steps, _ = tr.first_steps()
            rec.remove()
            sides[who] = {"steps": steps, "frozen": frozen,
                          "index": tr.indices()}
            if who == "program":
                inputs = (tr.sd, tr.names, tr.pool, rec.draws, frozen_draws)
            tr.free_program()
            del tr
            torch.cuda.empty_cache()
        ref = train_ffb6d.reference_side(cell["config"], *inputs, card)
        if i < CONTROL_SEEDS:
            sides["control"] = train_ffb6d.reference_side(
                cell["config"], *inputs, card, low_precision=True)
        for who, got in sides.items():
            checks, ok = train_ffb6d.check(got, ref, cell["limits"])
            _emit({"cell": CELL, "seed": seed, "who": who, "correct": ok,
                   "checks": checks,
                   "numbers": train_ffb6d.compare(got, ref)})
            if ok != (who == "program"):
                wrong.append((seed, who))
        del inputs, ref, sides
        torch.cuda.empty_cache()
    assert not wrong, wrong
