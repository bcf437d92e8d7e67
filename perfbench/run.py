"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload ycb-serve-raw --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout.  The cell, its configuration, traffic mix,
metrics and limits are found by name (``perfbench/spec.py``); the mix's
driver (``perfbench/drivers/<driver>.py``) makes the inputs and weights
from ``--seed``, warms up, measures for ``--seconds`` (``--trace 1``: a
traced stretch, read by the per-layer metrics), checks what the timed
path produced against the plain reference, and returns its numbers.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number beside its
limit, also the last lines of standard error).  Exits non-zero and prints
no result without enough CUDA devices, or when JAX or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache of the run at a fixed path in the checkout;
# the port's nvcc libraries go to <checkout>/build/kernels by themselves.
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}
FORBIDDEN = ("jax", "jaxlib", "flax", "pvn3d_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``pvn3d_tpu_torch`` is not ``pvn3d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def result_line(out: dict, cell: dict, trace: bool) -> dict:
    """The printed object, keys in the contract's order and ``checks``
    last; each metric the cell reports in this mode, left out where its
    reader found nothing."""
    metrics = {}
    names = cell["per_layer"] if trace else cell["end_to_end"]
    for m in names:
        v = out["metrics"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = os.path.join(ROOT, v)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    from perfbench import spec
    cell = spec.cell(args.workload, ROOT)
    chips = cell["workload"]["chips"]

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    drv = spec.driver(cell["traffic"]["driver"])
    out = drv.run(cell, args, T_START)
    if out is None:                   # a rank that is not rank 0
        return 0
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded after the window: {found}",
              file=sys.stderr)
        return 3
    line = result_line(out, cell, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
