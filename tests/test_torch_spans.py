"""The port's spans (``utils/profiling.py``: ``annotate``, ``host_read``)
on the CPU: one ``pvn3d.request#<n>`` per serving call and one
``pvn3d.step#<n>`` per training step, each holding its stages' spans;
every host read inside a request or a step inside a ``pvn3d.read.<site>``
range; with no profiler running one shared null context and no range; and
the benchmark's readers of these spans (``perfbench/metrics``) on a small
synthetic trace."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from perfbench import spec, tracing  # noqa: E402
from perfbench.drivers import common  # noqa: E402
from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.data.synthetic import (synth_sensor_frame,  # noqa: E402
                                            synthetic_batch)
from pvn3d_tpu_torch.inference.pipeline import (  # noqa: E402
    make_raw_inference_step)
from pvn3d_tpu_torch.train.state import TrainState, make_optimizer  # noqa
from pvn3d_tpu_torch.train.step import make_train_step  # noqa: E402
from pvn3d_tpu_torch.utils import profiling as prof  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa: E402
                                          stacked_mesh_kps)
from pvn3d_tpu_torch.utils.weights import build_model  # noqa: E402
from tests.test_torch_train import _tiny_cfg  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]
REQUEST_STAGES = ("frame_build", "image_branch", "point_branch", "heads",
                  "pose_stage", "meanshift.ctr_filter", "meanshift.ctr",
                  "meanshift.kp")
STEP_STAGES = ("forward", "backward", "optimizer", "image_branch",
               "point_branch", "heads")
# Reads made only by code that never runs on the card, by the Python
# function that makes them.
EXEMPT = {
    "request": {},
    "step": {
        "three_interpolate_backward_plain":
            "K3 backward's plain version; the card launches "
            "csrc/interp_bwd.cu",
        "_single_tensor_adam":
            "Adam's loop on the CPU; the card runs the fused update, "
            "which reads nothing",
    },
}


def _profiled(fn, calls: int, with_stack: bool = False):
    """The events of ``calls`` calls of ``fn``; ``with_stack`` keeps the
    Python frames, which name an exempt read's function."""
    with torch.profiler.profile(activities=CPU, with_stack=with_stack) as p:
        for _ in range(calls):
            fn()
    return p.events()


@pytest.fixture(scope="module")
def request_events():
    """Two raw requests at the small configuration."""
    cfg = port_config.Config(model=port_config.small_model_config())
    h, w = cfg.model.image_height, cfg.model.image_width
    step = make_raw_inference_step(
        cfg, build_model(cfg.model, 0), stacked_mesh_kps(cfg.model.n_classes),
        stacked_class_radii(), device="cpu")
    rgb, depth, k = synth_sensor_frame(h, w, seed=0)
    batch = {"rgb": rgb, "depth": depth, "cam_k": k}

    def call():
        step(batch, generator=torch.Generator().manual_seed(0))
    return _profiled(call, 2)


@pytest.fixture(scope="module")
def step_events():
    """Two training steps at a tiny configuration."""
    cfg = _tiny_cfg()
    model = build_model(cfg.model, 0).train()
    state = TrainState(0, model, make_optimizer(cfg, model))
    step = make_train_step(cfg, "cpu")
    batch = synthetic_batch(cfg, batch_size=2, seed=0)

    def call():
        step(state, batch)
    return _profiled(call, 2, with_stack=True)


def _named(events, prefix):
    return [e for e in events if e.name.startswith(prefix)]


def _within(e, outer) -> bool:
    return (e.thread == outer.thread
            and outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("unit,stages", [("request", REQUEST_STAGES),
                                         ("step", STEP_STAGES)])
def test_each_call_is_one_span_holding_its_stages(unit, stages,
                                                  request_events,
                                                  step_events):
    events = request_events if unit == "request" else step_events
    tops = _named(events, f"pvn3d.{unit}#")
    assert sorted(e.name for e in tops) == [f"pvn3d.{unit}#0",
                                            f"pvn3d.{unit}#1"]
    for top in tops:
        for stage in stages:
            held = [e for e in _named(events, f"pvn3d.{stage}")
                    if e.name == f"pvn3d.{stage}" and _within(e, top)]
            assert len(held) == 1, (top.name, stage)
    for e in _named(events, "pvn3d."):
        assert any(_within(e, t) for t in tops), e.name


def test_train_mode_batch_norms_lie_in_the_forward(step_events):
    fwd = _named(step_events, "pvn3d.forward")
    bns = _named(step_events, "pvn3d.bn")
    assert len(bns) >= 2 * 40
    for bn in bns:
        assert any(_within(bn, f) for f in fwd)


def test_serving_batch_norms_open_no_span(request_events):
    assert not _named(request_events, "pvn3d.bn")


def _frames(e):
    q = e.cpu_parent
    while q is not None:
        yield q.name
        q = q.cpu_parent


@pytest.mark.parametrize("unit", ["request", "step"])
def test_every_host_read_is_named(unit, request_events, step_events):
    """Every ``aten::_local_scalar_dense`` (what ``float()``, ``bool()``
    and ``.item()`` become) inside a request or a step lies inside a
    ``pvn3d.read.<site>`` range, unless a function of ``EXEMPT`` makes
    it; each exemption is used."""
    events = request_events if unit == "request" else step_events
    tops = _named(events, f"pvn3d.{unit}#")
    reads = _named(events, "pvn3d.read.")
    used, named = set(), 0
    for e in events:
        if e.name != "aten::_local_scalar_dense" or not any(
                _within(e, t) for t in tops):
            continue
        if any(_within(e, r) for r in reads):
            named += 1
            continue
        fns = [f for f in _frames(e) for fn in EXEMPT[unit]
               if f.endswith(f": {fn}")]
        assert fns, f"an unnamed read: {list(_frames(e))[:6]}"
        used.update(f.rsplit(": ", 1)[1] for f in fns)
    assert used == set(EXEMPT[unit])
    if unit == "request":
        sites = {r.name for r in reads}
        assert {"pvn3d.read.meanshift_stop", "pvn3d.read.meanshift_threshold",
                "pvn3d.read.svd"} <= sites
        assert named >= len(tops) * 3


def test_annotate_without_a_profiler_is_one_null_context(monkeypatch):
    def no_range(*_a, **_k):
        raise AssertionError("a range was opened")
    monkeypatch.setattr(prof, "_RecordFunctionFast", no_range)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_range)
    monkeypatch.setattr(torch.cuda.nvtx, "range", no_range)
    assert not torch._C._autograd._profiler_enabled()
    a, b = prof.annotate("pvn3d.a"), prof.annotate("pvn3d.b", 3)
    assert a is b
    with a, b:
        pass
    assert prof.host_read("site", torch.tensor(2.5)) == 2.5
    assert prof.host_read("site", torch.tensor(True), bool) is True
    # The patch is what a running profiler reaches.
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(AssertionError, match="range was opened"):
            prof.annotate("pvn3d.c")


def test_annotate_is_a_host_range_named_as_given():
    x = torch.arange(4.0)
    with torch.profiler.profile(activities=CPU) as p:
        with prof.annotate("pvn3d.x"):
            with prof.annotate("pvn3d.y", 7):
                got = prof.host_read("site", x.sum())
                host = prof.host_read("copy", x, torch.Tensor.cpu)
        with torch.profiler.record_function("user_scope"):
            pass
    assert got == 6.0 and torch.equal(host, x)
    ev = {e.name(): e for e in p.profiler.kineto_results.events()}
    for name in ("pvn3d.x", "pvn3d.y#7", "pvn3d.read.site",
                 "pvn3d.read.copy"):
        # A function-scope host range: the profiler puts no copy of it
        # on the device timeline, as it does for a user-scope range.
        assert not ev[name].is_user_annotation(), name
        assert ev[name].device_type() == torch.autograd.DeviceType.CPU
    assert ev["user_scope"].is_user_annotation()
    fe = p.events()
    site = [e for e in fe if e.name == "pvn3d.read.site"]
    assert any(e.name == "aten::_local_scalar_dense" and _within(e, site[0])
               for e in fe)


# ------------------------------------------------ the benchmark's readers

class _Ev:
    """A kineto event as ``perfbench.tracing.Trace`` reads one; times in
    ms."""

    def __init__(self, name, t0, t1, corr=0, cuda=False, tid=1):
        self._n, self._t0, self._t1 = name, t0, t1
        self._corr, self._cuda, self._tid = corr, cuda, tid

    def name(self):
        return self._n

    def device_type(self):
        from torch._C._autograd import DeviceType
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid

    def start_ns(self):
        return int(self._t0 * 1e6)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1e6)


def _serve_events(spans=True):
    """Two 10-ms requests; each launches 3 kernels (0.5 ms each on the
    device) and a copy inside a read; reads of 1 and 0.5 ms.  A kernel
    launched outside the request belongs to none."""
    ev, corr = [], iter(range(1, 1000))
    for u in range(2):
        t = 10.0 * u
        ev.append(_Ev(f"pb.unit#{u}", t, t + 10))
        if spans:
            ev += [_Ev(f"pvn3d.request#{u}", t + 0.5, t + 9.5),
                   _Ev("pvn3d.read.meanshift_stop", t + 6, t + 7),
                   _Ev("pvn3d.read.svd", t + 8, t + 8.5)]
        for at, name in ((1, "k"), (2, "k"), (3, "k"),
                         (6.1, "Memcpy DtoH"), (9.8, "k")):
            c = next(corr)
            launch = "cudaMemcpyAsync" if "Memcpy" in name else \
                "cudaLaunchKernel"
            ev += [_Ev(launch, t + at, t + at + 0.01, c),
                   _Ev(name, t + at + 0.1, t + at + 0.6, c, cuda=True)]
    return ev


def _train_events(spans=True):
    """One step: a forward holding two BNs, each launching a 0.2-ms
    kernel, and a 0.5-ms kernel outside them; a 2-ms kernel in the
    backward."""
    ev = [_Ev("pb.unit#0", 0, 20)]
    if spans:
        ev += [_Ev("pvn3d.step#0", 0.5, 19), _Ev("pvn3d.forward", 1, 5),
               _Ev("pvn3d.bn", 1.5, 2), _Ev("pvn3d.bn", 3, 3.5),
               _Ev("pvn3d.backward", 6, 15)]
    for c, (at, dur) in enumerate(((1.6, 0.2), (3.1, 0.2), (4, 0.5),
                                   (7, 2.0)), 1):
        ev += [_Ev("cudaLaunchKernel", at, at + 0.01, c),
               _Ev("k", at + 0.1, at + 0.1 + dur, c, cuda=True)]
    return ev


READERS = {
    "host_reads.serve": (_serve_events, 2.0),
    "host_read_wait_ms.serve": (_serve_events, 1.5),
    "launches.serve": (_serve_events, 4.0),
    "forward_device_ms.train": (_train_events, 0.9),
    "bn_forward_device_ms.train": (_train_events, 0.4),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_synthetic_trace(metric):
    """Each reader's number from a small synthetic trace, and nothing
    from the same trace without the program's spans (a program that has
    none, as before they existed)."""
    events, want = READERS[metric]
    read = spec.reader(metric)
    for spans, expect in ((True, want), (False, None)):
        p = type("P", (), {})()
        p.profiler = type("K", (), {})()
        p.profiler.kineto_results = type("R", (), {})()
        p.profiler.kineto_results.events = (lambda s=spans: events(s))
        trace = tracing.Trace(p, tracing.Spans())
        got = read(common.Reading(trace, 1, 1.0, tracing.Spans()))
        if expect is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, expect, rtol=1e-4)

