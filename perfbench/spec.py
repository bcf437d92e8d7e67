"""What a run is: its cell, configuration, traffic mix, metrics and limits,
each found by name in ``BENCHMARK.json`` and in files of its own.

- ``perfbench/configs/<config>.json``: the configuration as it is run (the
  port's ``Config`` tree under ``program``, camera, depth scale, mesh
  keypoints and cluster radii);
- ``perfbench/traffic/<traffic>.json``: the mix's parameters and the
  ``driver`` (``perfbench/drivers/<driver>.py``) that runs it;
- ``perfbench/metrics/<metric>.py``: a reader with ``read(ctx)`` that
  returns a number, or None when the run gives it nothing to read;
- ``perfbench/limits/<workload>.json``, or where a cell has none
  ``perfbench/limits/<driver>.json``: the limit of each number that the
  driver's correctness check compares.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import typing
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Dict:
    """The workload ``name`` with its configuration, traffic, metrics and
    limits: ``{"workload", "config", "traffic", "end_to_end",
    "per_layer", "limits"}``, from the checkout at ``root``."""
    bench = benchmark(root)
    here = os.path.join(root, "perfbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]

    def mine(metric):
        return name in metric.get("workloads", [name])
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    return {
        "workload": w,
        "config": _json(os.path.join(here, "configs", w["config"] + ".json")),
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
        "limits": _json(limits_file(here, name, traffic["driver"])),
    }


def limits_file(here: str, workload: str, driver: str) -> str:
    """The cell's own limits where it has a file, else its driver's: a
    later cell on an existing driver brings its limits as a new file."""
    own = os.path.join(here, "limits", workload + ".json")
    return own if os.path.exists(own) else os.path.join(
        here, "limits", driver + ".json")


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``perfbench/metrics/<metric>.py`` (metric
    names hold dots, so the file is loaded by its path)."""
    path = os.path.join(root, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _build(tp, value):
    """``value`` (parsed JSON) as an instance of the annotation ``tp``:
    dataclasses field by field (missing fields keep their defaults),
    tuples element by element."""
    if dataclasses.is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        return tp(**{f.name: _build(hints[f.name], value[f.name])
                     for f in dataclasses.fields(tp) if f.name in value})
    origin = typing.get_origin(tp)
    if origin is tuple:
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_build(args[0], v) for v in value)
        return tuple(_build(a, v) for a, v in zip(args, value))
    return value


def program_config(config: Dict):
    """The port's ``Config`` holding every number of the configuration
    file's ``program`` tree."""
    from pvn3d_tpu_torch.config import Config
    cfg = _build(Config, config["program"])

    def holds(got, want):
        if isinstance(want, dict):
            return all(k in got and holds(got[k], v) for k, v in want.items())
        return got == want
    if not holds(json.loads(json.dumps(dataclasses.asdict(cfg))),
                 config["program"]):
        raise SystemExit(f"configuration {config['name']}: the port's "
                         f"Config does not hold the file's numbers")
    return cfg
