"""On the card, at each cell's own size: the readings that the limits in
``perfbench/limits`` are set from.  For each seed, the program's numbers
(as a run's check computes them) and the control's: the reference one
precision below the configuration's, in the program's place.  Training
cells also read the half-batch fault.  Every reading is printed as a JSON
line (and appended to ``$PERFBENCH_OUT`` when set); the control and the
fault must come out not correct, the program correct.

    python3 -m pytest perfbench/tests/test_perfbench_card.py -s

``PERFBENCH_SEEDS`` (comma-separated) replaces the default seeds;
``PERFBENCH_CONTROL_SEEDS`` is how many of them also read the control.
"""
import json
import os
import types

import pytest
import torch

from perfbench import spec
from perfbench.drivers import common, serve_raw, train

SEEDS = [int(s) for s in os.environ.get(
    "PERFBENCH_SEEDS", "1000003,2147483659,3000000019").split(",")]
CONTROL_SEEDS = int(os.environ.get("PERFBENCH_CONTROL_SEEDS", "3"))


def _emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if os.environ.get("PERFBENCH_OUT"):
        with open(os.environ["PERFBENCH_OUT"], "a") as f:
            f.write(line + "\n")


def _free():
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ycb-serve-raw", "lm-serve-raw"])
def test_serve_readings(card, workload):
    cell = spec.cell(workload)
    wrong = []
    for i, seed in enumerate(SEEDS):
        srv = serve_raw.Server(cell, seed, card)
        srv.make_step(False)
        for _ in range(cell["traffic"]["warmup"] + 2 * cell["traffic"]
                       ["check_frames"]):
            srv.request(srv.next_frame())
        srv.free_program()
        checks, ok = srv.check(seed, cell["limits"])
        _emit({"cell": workload, "seed": seed, "who": "program",
               "correct": ok, "checks": checks})
        wrong += [] if ok else [(seed, "program")]
        if i < CONTROL_SEEDS:
            checks, ok = srv.check(seed, cell["limits"], lambda j: (
                serve_raw.control(srv.config, srv.sd, srv.frames[j],
                                  srv.prio[j:j + 1], card)))
            _emit({"cell": workload, "seed": seed, "who": "control",
                   "correct": ok, "checks": checks})
            wrong += [(seed, "control")] if ok else []
        del srv
        _free()
    assert not wrong


def _train_candidates(got, ref, counted):
    """Gaps of norms that the check does not compare, read beside it:
    each step's loss, the whole first gradient and change over the
    counted leaves, the largest leaf's first gradient."""
    def whole(d):
        return sum(d[k] ** 2 for k in counted) ** 0.5

    def gap(a, b):
        return abs(a - b) / abs(b)
    big = max(counted, key=ref[1].get)
    return {"loss_step_gaps": [gap(a, b) for a, b in zip(got[0], ref[0])],
            "grad_whole_gap": gap(whole(got[1]), whole(ref[1])),
            "change_whole_gap": gap(whole(got[2]), whole(ref[2])),
            "grad_big_leaf_gap": gap(got[1][big], ref[1][big])}


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ycb-train-b24"])
def test_train_readings(card, workload):
    cell = spec.cell(workload)
    wrong = []
    for i, seed in enumerate(SEEDS):
        args = types.SimpleNamespace(workload=workload, seed=seed, rank=0)
        readings = {}
        for who in ("program", "half_batch")[:1 + (i < CONTROL_SEEDS)]:
            tr = train.Trainer(cell, args, card)
            if who == "half_batch":
                half = cell["traffic"]["batch"] // 2
                tr.local = [{k: v[:half] for k, v in b.items()}
                            for b in tr.local]
            rec = train.DropoutRecord()
            rec.install()
            readings[who], _ = tr.first_steps()
            rec.remove()
            tr.free_program()
            if who == "program":
                inputs = (tr.sd, tr.names, tr.pool,
                          train.reference_masks([rec.draws], card,
                                               cell["traffic"]["batch"]))
            del tr
            _free()
        ref = train.reference_steps(cell["config"], *inputs)
        if i < CONTROL_SEEDS:
            readings["control"] = train.reference_steps(
                cell["config"], *inputs, low_precision=True)
        counted = train.counted_leaves(ref[1])
        for who, got in readings.items():
            checks, ok = common.checks(train.compare(got, ref),
                                       cell["limits"])
            gaps = train.leaf_gaps(got[1], ref[1], counted)
            worst = sorted(gaps, key=gaps.get)[-3:]
            _emit({"cell": workload, "seed": seed, "who": who,
                   "correct": ok, "checks": checks,
                   "worst_grad_leaves": {k: [gaps[k], got[1][k], ref[1][k]]
                                         for k in worst},
                   "beside": _train_candidates(got, ref, counted),
                   "leaves": [len(counted), len(ref[1])]})
            wrong += [] if ok == (who == "program") else [(seed, who)]
        del inputs, ref, readings
        _free()
    assert not wrong
