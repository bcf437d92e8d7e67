"""Spans the benchmark puts around calls into the port, and the reduction
of one in-memory ``torch.profiler`` trace to what the metric readers read.

A span is a ``torch.profiler.record_function`` range named
``pb.<layer>#<n>``, opened by a forward pre-hook on a module and closed
by its forward hook, or around a call of a wrapped function.  Functions
are wrapped where the port's modules bind them, so a call site that
imported the function by name goes through the wrapper too.  A wrapped
kernel entry point also keeps what its work count needs (shapes, the
result's indices), reckoned once the trace has ended.

Device kernels are attributed to spans by correlation id: each device
record's launch call lies on a host thread at a host time, and the spans
on that thread that hold the time hold the kernel.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import sys
from typing import Callable, Dict, List, Optional

import torch

from perfbench import stats

_LAUNCH = ("LaunchKernel", "Memcpy", "Memset")
PACKAGE = "pvn3d_tpu_torch"


class Spans:
    """Hooks and wrappers that open spans, and the kernel calls they saw.
    ``remove()`` puts everything back."""

    def __init__(self):
        self._undo: List[Callable] = []
        self._ids = itertools.count()
        self.calls: List[Dict] = []     # wrapped kernel calls: span, work
        self.missing: List[str] = []

    def _name(self, layer: str) -> str:
        return f"pb.{layer}#{next(self._ids)}"

    def module(self, root, path: str, layer: str) -> None:
        """A span around each forward of ``root``'s submodule ``path``."""
        try:
            mod = root.get_submodule(path)
        except AttributeError:
            self.missing.append(path)
            return
        stack = []

        def pre(_m, _a):
            rf = torch.profiler.record_function(self._name(layer))
            rf.__enter__()
            stack.append(rf)

        def post(_m, _a, _o):
            stack.pop().__exit__(None, None, None)
        handles = [mod.register_forward_pre_hook(pre),
                   mod.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def function(self, module_name: str, attr: str, layer: str,
                 work: Optional[Callable] = None, wrap_result=None) -> None:
        """A span around each call of ``module_name.attr`` wherever the
        port binds it.  ``work(args, kwargs, out)`` returns a thunk that
        gives (bytes, flops) after the trace; ``wrap_result(out)`` wraps a
        returned function in a span of its own (a factory's closure)."""
        mod = sys.modules.get(module_name)
        orig = getattr(mod, attr, None) if mod is not None else None
        if orig is None:
            self.missing.append(f"{module_name}.{attr}")
            return

        def wrapper(*args, **kwargs):
            name = self._name(layer)
            with torch.profiler.record_function(name):
                out = orig(*args, **kwargs)
            if work is not None:
                self.calls.append({"span": name, "layer": layer,
                                   "work": work(args, kwargs, out)})
            return wrap_result(out) if wrap_result else out

        bound = [(m, a) for m in list(sys.modules.values())
                 if getattr(m, "__name__", "").split(".")[0] == PACKAGE
                 for a, v in list(vars(m).items()) if v is orig]
        for m, a in bound:
            setattr(m, a, wrapper)
        self._undo.append(lambda: [setattr(m, a, orig) for m, a in bound])

    def closure(self, layer: str) -> Callable:
        """A ``wrap_result`` that puts a span around each call of the
        returned function."""
        def wrap(fn):
            def inner(*args, **kwargs):
                with torch.profiler.record_function(self._name(layer)):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


class Trace:
    """One trace reduced: spans (name, layer, thread, start, end), device
    records (name, start, end, launch thread and time), host ops; times in
    seconds on the profiler's clock."""

    def __init__(self, prof, spans: Spans):
        from torch._C._autograd import DeviceType
        ev = list(prof.profiler.kineto_results.events())
        host = [e for e in ev if e.device_type() != DeviceType.CUDA]
        launch = {e.correlation_id(): (e.start_thread_id(),
                                       e.start_ns() * 1e-9)
                  for e in host if any(k in e.name() for k in _LAUNCH)}
        self.device = []
        for e in ev:
            # The spans' own ranges on the device timeline are no records.
            if (e.device_type() != DeviceType.CUDA
                    or e.name().startswith("pb.")):
                continue
            t0 = e.start_ns() * 1e-9
            tid, at = launch.get(e.correlation_id(), (None, None))
            self.device.append({"name": e.name(), "start": t0,
                                "end": t0 + e.duration_ns() * 1e-9,
                                "tid": tid, "at": at})
        self.spans = []
        self.ops = collections.defaultdict(list)
        for e in host:
            t0 = e.start_ns() * 1e-9
            rec = {"name": e.name(), "tid": e.start_thread_id(), "start": t0,
                   "end": t0 + e.duration_ns() * 1e-9}
            if e.name().startswith("pb."):
                rec["layer"] = e.name()[3:].split("#")[0]
                self.spans.append(rec)
            else:
                self.ops[e.name()].append(rec)
        # Launches per thread, sorted by host time, with prefix sums of
        # their device seconds.
        by_tid = collections.defaultdict(list)
        for d in self.device:
            if d["tid"] is not None:
                by_tid[d["tid"]].append((d["at"], d["end"] - d["start"]))
        self._at = {}
        for tid, rows in by_tid.items():
            rows.sort()
            self._at[tid] = ([r[0] for r in rows],
                             [0.0] + list(itertools.accumulate(
                                 r[1] for r in rows)))

    def device_in(self, rec) -> float:
        """Device seconds of the records launched inside ``rec``'s time on
        its thread."""
        if rec["tid"] not in self._at:
            return 0.0
        ats, acc = self._at[rec["tid"]]
        i = bisect.bisect_left(ats, rec["start"])
        j = bisect.bisect_right(ats, rec["end"])
        return acc[j] - acc[i]

    def layer(self, layer: str) -> List[Dict]:
        return [s for s in self.spans if s["layer"] == layer]

    def window(self):
        """The traced units' window: the first unit span's start to the
        last one's end."""
        units = self.layer("unit")
        return min(s["start"] for s in units), max(s["end"] for s in units)

    def busy_s(self) -> float:
        lo, hi = self.window()
        return stats.union_seconds([(max(d["start"], lo), min(d["end"], hi))
                                    for d in self.device
                                    if d["end"] > lo and d["start"] < hi])

    def device_under(self, op_prefix: str) -> float:
        """Device seconds launched inside host ops named ``op_prefix``...
        (outermost ranges only)."""
        recs = [r for k, v in self.ops.items() if k.startswith(op_prefix)
                for r in v]
        recs.sort(key=lambda r: (r["tid"], r["start"]))
        total, last = 0.0, {}
        for r in recs:
            if r["start"] < last.get(r["tid"], -1.0):
                continue                      # nested inside the previous
            last[r["tid"]] = r["end"]
            total += self.device_in(r)
        return total

    def breakdown(self) -> Dict:
        """The ten device ops that took most time, and the ten longest idle
        gaps named by the innermost span the host was in."""
        by_name = collections.Counter()
        for d in self.device:
            by_name[d["name"][:120]] += d["end"] - d["start"]
        lo, hi = self.window()
        busy = sorted((d["start"], d["end"]) for d in self.device
                      if d["end"] > lo and d["start"] < hi)
        gaps, end = [], lo
        for s, e in busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        named = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [sp for sp in self.spans if sp["start"] <= mid
                     <= sp["end"]]
            label = (min(inner, key=lambda sp: sp["end"] - sp["start"])
                     ["layer"] if inner else "no span")
            named[label] += e - s
        return {"device_ops": [[k, v] for k, v in by_name.most_common(10)],
                "idle_gaps": [[k, v] for k, v in named.most_common(10)]}
