"""The port's measurement harness (``utils/profiling.py``) against the
contract of the JAX package's (``tests/test_profiling.py``, case for
case): the MEDIAN of >= 3 salted trials wins, replays are rejected by a
physics floor (never by electing the slowest), stalls are rejected by a
robust-median test, and every rejection stays on the record.  The trial
logic runs on injected trial times through the ``_timed`` hook, as
JAX's cases do, and the same times give JAX's harness and the port's the
same record; the real loop runs on the CPU (``perf_counter``); on the
card its trials are CUDA-event times, which ``chip_smoke.py`` [apps]
exercises.  Plus ``trace`` and ``annotate`` on the CPU (the spans:
``tests/test_torch_spans.py``).
"""
import glob
import json
import os
import time

import numpy as np
import pytest

from pvn3d_tpu.utils import profiling as jax_prof

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.utils import profiling as prof  # noqa: E402
from pvn3d_tpu_torch.utils.profiling import (  # noqa: E402
    device_loop_stats, device_loop_time)


def _fake_timer(seq):
    it = iter(seq)

    def timed():
        try:
            return next(it)
        except StopIteration:  # pragma: no cover - budget bug guard
            pytest.fail("harness drew more trials than its budget")
    return timed


def _both(seq, **kw):
    """The port's record and JAX's on the same trial times (JAX's fixed
    tunnel floor applies off its CPU backend only: here it is off)."""
    got = device_loop_stats(None, _timed=_fake_timer(seq), **kw)
    want = jax_prof.device_loop_stats(None, _timed=_fake_timer(seq), **kw)
    assert got == want
    return got


def test_one_stall_cannot_shift_the_median():
    seq = [0.10, 5.0, 0.10, 0.11, 0.10, 0.09, 0.10]
    s = _both(seq, iters=10, trials=3)
    assert s["s_per_iter"] == pytest.approx(0.10 / 10, rel=0.15)
    assert s["rejected_stall_s"] == [5.0]
    assert s["suspect"] is None


def test_replay_rejected_by_physics_floor_not_by_electing_slowest():
    seq = [0.0001, 0.10, 0.11, 0.10]
    s = _both(seq, iters=10, trials=3, floor_s_per_iter=0.005)
    assert s["rejected_replay_s"] == [0.0001]
    assert s["s_per_iter"] == pytest.approx(0.10 / 10, rel=0.15)
    assert s["suspect"] is None


def test_all_replays_flags_suspect_instead_of_hiding():
    seq = [0.0001] * 7
    s = _both(seq, iters=10, trials=3, floor_s_per_iter=0.005)
    assert s["suspect"] == "replay"
    assert s["s_per_iter"] == pytest.approx(0.0001 / 10)


def test_persistent_spread_flags_suspect():
    seq = [0.10, 0.30, 0.10, 0.30, 0.10, 0.30, 0.10]
    s = _both(seq, iters=10, trials=3)
    assert s["suspect"] == "spread"
    assert len(s["trials_s"]) == 7  # exhausted its retry budget


def test_clean_trials_stop_at_n():
    seq = [0.10, 0.101, 0.099]
    s = _both(seq, iters=5, trials=3)
    assert len(s["trials_s"]) == 3
    assert s["suspect"] is None
    assert s["spread"] <= 1.1


def test_injected_fetch_stall_cannot_shift_reported_value(monkeypatch):
    """A real loop on the CPU: one trial's read stalls (a sleep at the
    ``_fetch`` seam) and the reported number does not move materially."""
    real_fetch = prof._fetch
    calls = {"n": 0}

    def stalling_fetch(x):
        calls["n"] += 1
        if calls["n"] == 2:          # stall exactly one timed trial
            time.sleep(1.0)
        return real_fetch(x)

    monkeypatch.setattr(prof, "_fetch", stalling_fetch)
    s = device_loop_stats(lambda i: torch.sum(i * 2.0), iters=4, trials=3,
                          device="cpu")
    assert s["s_per_iter"] < 0.25    # the 1 s stall did not win
    assert calls["n"] >= 3
    assert s["rejected_stall_s"] and s["rejected_stall_s"][0] >= 1.0


def test_device_loop_time_float_wrapper():
    dt = device_loop_time(lambda i: i * 2.0, iters=4, device="cpu")
    assert np.isfinite(dt) and dt >= 0


def test_real_loop_sums_each_salted_call(monkeypatch):
    """A trial calls ``fn`` on iters consecutive salted indices and sums
    them onto its salt; the warm-up and each trial get their own salt,
    and a slow ``fn`` reads as its time a call."""
    seen, sums = [], []
    real_fetch = prof._fetch
    monkeypatch.setattr(prof, "_fetch",
                        lambda x: sums.append(real_fetch(x)) or sums[-1])

    def fn(i):
        assert i.dtype == torch.float32 and i.dim() == 0
        seen.append(float(i))
        time.sleep(0.005)
        return i * 0.0 + 1.0

    s = device_loop_stats(fn, iters=3, trials=3, device="cpu")
    assert len(seen) == 3 * (1 + len(s["trials_s"]))
    salts = [seen[k] for k in range(0, len(seen), 3)]
    assert len(set(salts)) == len(salts)
    for k, salt in enumerate(salts):
        assert seen[3 * k:3 * k + 3] == pytest.approx([salt, salt + 1,
                                                       salt + 2])
        assert sums[k] == pytest.approx(salt + 3.0)
    assert 0.005 <= s["s_per_iter"] < 0.05
    assert s["iters"] == 3 and s["suspect"] is None


def test_device_loop_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_loop_stats(lambda i: i, iters=2)


def test_trace_writes_a_chrome_trace_naming_annotations(tmp_path):
    x = torch.randn(64, 64)
    with prof.trace(str(tmp_path)):
        with prof.annotate("stage_matmul"):
            y = x @ x
        with prof.annotate("stage_sum"):
            float(y.sum())
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stage_matmul", "stage_sum"} <= names
    assert any("mm" in (n or "") for n in names)
