"""Host ms a request spends inside the program's blocking reads: the
``pvn3d.read.<site>`` ranges inside its ``pvn3d.request#<n>`` ranges on the
same thread.  A read returns when the device has drained the work queued
before it, so this is the host waiting on the device."""


def _ranges(ctx, prefix):
    return [r for k, v in ctx.trace.ops.items() if k.startswith(prefix)
            for r in v]


def read(ctx):
    reqs = _ranges(ctx, "pvn3d.request#")
    if not reqs:
        return None
    s = sum(r["end"] - r["start"] for r in _ranges(ctx, "pvn3d.read.")
            if any(q["tid"] == r["tid"] and q["start"] <= r["start"]
                   and r["end"] <= q["end"] for q in reqs))
    return s * 1e3 / len(reqs)
