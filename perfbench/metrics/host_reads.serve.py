"""Blocking host reads a request makes, at every site: the program's
``pvn3d.read.<site>`` ranges inside its ``pvn3d.request#<n>`` ranges on
the same thread (``pvn3d_tpu_torch/utils/profiling.py``)."""


def _ranges(ctx, prefix):
    return [r for k, v in ctx.trace.ops.items() if k.startswith(prefix)
            for r in v]


def read(ctx):
    reqs = _ranges(ctx, "pvn3d.request#")
    if not reqs:
        return None
    n = sum(any(q["tid"] == r["tid"] and q["start"] <= r["start"]
                and r["end"] <= q["end"] for q in reqs)
            for r in _ranges(ctx, "pvn3d.read."))
    return n / len(reqs)
