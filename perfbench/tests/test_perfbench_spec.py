"""The benchmark is driven by data: every cell, configuration, traffic mix,
per-layer metric and limit is found by name in files of its own, and a
new one is added by adding files and ``BENCHMARK.json`` entries."""
import json
import os
import re
import shutil

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_found_by_name(workload):
    c = spec.cell(workload)
    assert c["workload"]["name"] == workload
    assert c["config"]["name"] == c["workload"]["config"]
    assert spec.driver(c["traffic"]["driver"]).run
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in names
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())


def test_benchmark_file_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    assert len({x["name"] for x in every}) == len(every)
    for x in every:
        assert NAME.match(x["name"]), x["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert not c["reduced"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("config", ["ycb", "linemod-ape"])
def test_configuration_file_holds_the_ports_published_config(config):
    from pvn3d_tpu_torch.config import Config
    c = spec.cell(next(w["name"] for w in BENCH["workloads"]
                       if w["config"] == config))["config"]
    want = Config.ycb() if config == "ycb" else Config.linemod("ape")
    assert spec.program_config(c) == want
    assert len(c["mesh_kps"]) == want.model.n_classes
    assert len(c["radii"]) == want.model.n_classes


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    """A later change adds files and entries only: here a configuration, a
    mix, a metric and a cell in a copy of the checkout's data."""
    root = tmp_path
    shutil.copytree(spec.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(root / "perfbench/configs/ycb.json"))
    cfg["name"] = "ycb-wide"
    json.dump(cfg, open(root / "perfbench/configs/ycb-wide.json", "w"))
    mix = json.load(open(root / "perfbench/traffic/raw_closed.json"))
    mix["pool"] = 8
    json.dump(mix, open(root / "perfbench/traffic/raw_small_pool.json", "w"))
    (root / "perfbench/metrics/new_share.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    own = dict(json.load(open(root / "perfbench/limits/serve_raw.json")),
               seg_rel=0.02)
    json.dump(own, open(root / "perfbench/limits/ycb-wide-serve.json", "w"))
    bench["configs"].append(dict(bench["configs"][0], name="ycb-wide",
                                 file="perfbench/configs/ycb-wide.json"))
    bench["workloads"].append({"name": "ycb-wide-serve", "config":
                               "ycb-wide", "traffic": "raw_small_pool",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_share.serve", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "serve_p95_ms",
                               "workloads": ["ycb-wide-serve"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ycb-serve-raw" in m["workloads"]:
            m["workloads"].append("ycb-wide-serve")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    c = spec.cell("ycb-wide-serve", str(root))
    assert c["traffic"]["pool"] == 8
    assert c["config"]["name"] == "ycb-wide"
    assert [m["name"] for m in c["per_layer"]] == ["new_share.serve"]
    assert spec.reader("new_share.serve", str(root))(None) == 42.0
    # The new cell's own limits; the cells of its driver keep theirs.
    assert c["limits"] == own
    assert spec.cell("ycb-serve-raw", str(root))["limits"] == json.load(
        open(root / "perfbench/limits/serve_raw.json"))
