"""The reader of ``meanshift_device_loops.serve`` on a synthetic trace: the
program's ``pvn3d.meanshift.device_loop`` ranges a ``pvn3d.request#<n>``,
counted only inside a request on its thread."""
import pytest
import torch

from perfbench import spec, tracing
from perfbench.drivers import common

METRIC = "meanshift_device_loops.serve"


class _Ev:
    """A kineto host event as ``perfbench.tracing.Trace`` reads one; times
    in ms."""

    def __init__(self, name, t0, t1, tid=1):
        self._n, self._t0, self._t1, self._tid = name, t0, t1, tid

    def name(self):
        return self._n

    def device_type(self):
        from torch._C._autograd import DeviceType
        return DeviceType.CPU

    def correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._tid

    def start_ns(self):
        return int(self._t0 * 1e6)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1e6)


def _events(loops_a_request: int, requests: bool = True):
    """20 units of 10 ms; each holds a request, which holds a
    ``pvn3d.pose_stage`` with ``loops_a_request`` shift loops in it.  A
    loop outside any request, and one on another thread inside a request's
    time, belong to none."""
    ev = [_Ev("pvn3d.meanshift.device_loop", 250.0, 251.0)]
    for u in range(20):
        t = 10.0 * u
        ev.append(_Ev(f"pb.unit#{u}", t, t + 10))
        if requests:
            ev += [_Ev(f"pvn3d.request#{u}", t + 0.5, t + 9.5),
                   _Ev("pvn3d.pose_stage", t + 6, t + 9)]
        ev += [_Ev("pvn3d.meanshift.device_loop", t + 6.1 + 0.3 * k,
                   t + 6.2 + 0.3 * k) for k in range(loops_a_request)]
        ev.append(_Ev("pvn3d.meanshift.device_loop", t + 7, t + 7.1, tid=2))
    return ev


def _read(events):
    p = type("P", (), {})()
    p.profiler = type("K", (), {})()
    p.profiler.kineto_results = type("R", (), {})()
    p.profiler.kineto_results.events = lambda: events
    trace = tracing.Trace(p, tracing.Spans())
    return spec.reader(METRIC)(common.Reading(trace, 1, 1.0,
                                              tracing.Spans()))


@pytest.mark.parametrize("loops,want", [(3, 3.0), (2, 2.0), (0, 0.0)])
def test_loops_a_request(loops, want):
    """3 a YCB or FFB6D request, 2 a LineMOD one, 0 where the fits run
    the plain loop."""
    assert _read(_events(loops)) == pytest.approx(want)


def test_nothing_without_requests():
    assert _read(_events(3, requests=False)) is None


def test_metric_is_declared_for_the_serving_cells():
    bench = spec.benchmark()
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    serving = [w["name"] for w in bench["workloads"]
               if w["name"].endswith("serve-raw")]
    assert m["workloads"] == serving and m["moves"] == "serve_p95_ms"
    assert m["source"] == "program_span" and m["unit"] == "loops/req"
    assert m["layer"] == next(x["layer"] for x in bench["per_layer"]
                              if x["name"] == "pose_stage_ms.serve")
