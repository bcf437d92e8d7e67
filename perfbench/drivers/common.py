"""What the drivers share: the port's model with the benchmark's weights,
the device record, the traced stretch and its reading, the checks."""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import torch

from perfbench import tracing, work


def port_model(cfg, seed: int, device):
    """The port's ``PVN3D`` for ``cfg.model`` holding the seed's weights
    (made on ``device``), and those weights: the same dict goes to the
    reference."""
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    from perfbench import scenes
    with torch.device("meta"):
        model = PVN3D(cfg.model)
    sd = scenes.state_dict(model, seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model, sd


def setup_log(t_start: float, phase: str) -> None:
    """Seconds since the process started, at the end of a set-up phase
    (standard error)."""
    print(f"perfbench: set-up {phase} done at "
          f"{time.perf_counter() - t_start:.2f} s", file=sys.stderr,
          flush=True)


def device_record(device, count: int, peak: int) -> Dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": count, "memory_peak_bytes": int(peak)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def profile(units: Callable[[Callable], None], device):
    """Run ``units(span)`` under the profiler (CPU and CUDA activity, in
    memory) and return it; ``span()`` gives the context of one traced
    unit (a request or a step)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    ids = iter(range(1 << 30))
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        units(lambda: torch.profiler.record_function(
            f"pb.unit#{next(ids)}"))
        sync(device)
    return prof


class Reading:
    """What a per-layer metric reader reads: the reduced trace, the unit
    (request or step) count, frames a unit and FLOPs a frame."""

    def __init__(self, trace: tracing.Trace, frames: int,
                 flops_per_frame: float, spans: tracing.Spans,
                 world: int = 1, unit_s=None):
        self.trace = trace
        self.frames = frames
        self.flops = flops_per_frame
        self.world = world
        self.units = trace.layer("unit")
        self.calls = spans.calls
        # Seconds a unit takes untraced, where the driver measured it; else
        # the traced window's share of a unit.
        self.unit_s = unit_s or self.window_s() / len(self.units)

    def per_unit_ms(self, layers: List[str]):
        """Host wall ms a unit spent in ``layers``' spans, or None when
        none of them opened."""
        spans = [s for s in self.trace.spans if s["layer"] in layers]
        if not spans:
            return None
        return sum(s["end"] - s["start"] for s in spans) * 1e3 / len(
            self.units)

    def window_s(self) -> float:
        lo, hi = self.trace.window()
        return hi - lo

    def busy_s(self) -> float:
        return self.trace.busy_s()

    def idle_pct(self):
        """The share of a unit's time with no device record running: the
        traced units' busy seconds a unit over ``unit_s``."""
        if self.unit_s <= 0:
            return None
        busy = self.busy_s() / len(self.units)
        return 100.0 * (1.0 - busy / self.unit_s)

    def mfu_pct(self, passes: float):
        """``passes`` x forward FLOPs of a unit's frames over ``unit_s`` at
        the bf16 peak."""
        return 100.0 * passes * self.flops * self.frames / (
            self.unit_s * work.PEAK_BF16)

    def roofline_pct(self, layers: List[str]):
        """Sum of least times over the device time of the wrapped kernel
        calls of ``layers``; None when no such call ran on the device."""
        least = spent = 0.0
        by_name = {c["span"]: c for c in self.calls}
        for sp in self.trace.spans:
            name = sp["name"]
            if sp["layer"] not in layers or name not in by_name:
                continue
            dev_s = self.trace.device_in(sp)
            if dev_s <= 0:
                continue
            n_bytes, flops = by_name[name]["work"]()
            least += work.least_seconds(n_bytes, flops)[0]
            spent += dev_s
        return None if spent <= 0 else 100.0 * least / spent

    def device_count(self, layers: List[str], name_part: str) -> int:
        """Device records whose name holds ``name_part`` launched inside
        ``layers``' spans."""
        n = 0
        for sp in self.trace.spans:
            if sp["layer"] not in layers:
                continue
            n += sum(d["tid"] == sp["tid"] and d["at"] is not None
                     and sp["start"] <= d["at"] <= sp["end"]
                     and name_part in d["name"] for d in self.trace.device)
        return n


def traced_result(out: Dict, cell: Dict, prof, spans: tracing.Spans,
                  frames: int, world: int = 1, unit_s=None) -> None:
    """Reduce the trace and fill ``out`` with the cell's per-layer
    metrics (a reader that finds nothing leaves its metric out), the
    device's busy and window seconds, and the breakdown.  ``unit_s``: the
    seconds a unit takes untraced, where the driver measured them."""
    from perfbench import spec
    reading = Reading(tracing.Trace(prof, spans), frames,
                      work.forward_flops(cell["config"]["program"]["model"]),
                      spans, world, unit_s)
    for name in spans.missing:
        print(f"perfbench: span target {name} not found; its metrics are "
              f"left out", flush=True)
    out["metrics"] = {}
    for m in cell["per_layer"]:
        v = spec.reader(m["name"])(reading)
        if v is None:
            print(f"perfbench: {m['name']}: nothing to read in this run",
                  flush=True)
        else:
            out["metrics"][m["name"]] = v
    out["device"].update(busy_s=reading.busy_s(),
                         window_s=reading.window_s())
    out["breakdown"] = reading.trace.breakdown()


def checks(numbers: Dict[str, float], limits: Dict[str, float]):
    """Each compared number beside its limit, and whether all hold."""
    out = {k: {"value": float(v), "limit": limits[k]}
           for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in out.values())
    return out, ok


KERNEL_WRAPS = (
    # (module, function, layer, work(args, kwargs, out) -> thunk)
    ("pvn3d_tpu_torch.ops.sampling", "furthest_point_sample", "k.fps",
     lambda a, kw, out: (lambda: work.fps_work(a[0], a[1], out))),
    ("pvn3d_tpu_torch.ops.grouping", "ball_query_multi", "k.query",
     lambda a, kw, out: (lambda: work.ball_query_work(a[0], a[1], a[2], a[3],
                                                      out))),
    ("pvn3d_tpu_torch.ops.kernels.interp", "three_interpolate_fused",
     "k.interp",
     lambda a, kw, out: (lambda s=(a[0].shape, a[1].shape, a[2].shape):
                         work.interp_work(*(torch.empty(x, device="meta")
                                            for x in s)))),
    ("pvn3d_tpu_torch.ops.kernels.interp", "three_interpolate_backward",
     "k.interp_bwd",
     lambda a, kw, out: (lambda s=a[0].shape, m=a[3]:
                         work.interp_backward_work(
                             torch.empty(s, device="meta"), m))),
    ("pvn3d_tpu_torch.ops.kernels.winner", "winner_stats", "k.winner",
     lambda a, kw, out: (lambda: work.winner_work(a[0], a[1]))),
)


def wrap_kernels(spans: tracing.Spans) -> None:
    for mod, fn, layer, w in KERNEL_WRAPS:
        spans.function(mod, fn, layer, work=w)
