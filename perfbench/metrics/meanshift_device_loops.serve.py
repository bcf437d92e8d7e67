"""Shift loops a request runs on the card: the program's
``pvn3d.meanshift.device_loop`` ranges (one a launch of the shift-loop
kernel, ``pvn3d_tpu_torch/ops/kernels/meanshift.py``) inside its
``pvn3d.request#<n>`` ranges on the same thread.  3 a YCB or FFB6D request
and 2 a LineMOD one where the kernel runs the fits, 0 where they run the
plain loop."""


def _ranges(ctx, prefix):
    return [r for k, v in ctx.trace.ops.items() if k.startswith(prefix)
            for r in v]


def read(ctx):
    reqs = _ranges(ctx, "pvn3d.request#")
    if not reqs:
        return None
    n = sum(any(q["tid"] == r["tid"] and q["start"] <= r["start"]
                and r["end"] <= q["end"] for q in reqs)
            for r in _ranges(ctx, "pvn3d.meanshift.device_loop"))
    return n / len(reqs)
