"""Host ms a step spends in the optimizer (``train/state.py``, fused Adam):
the profiler's own ``Optimizer.step#Adam.step`` range."""


def read(ctx):
    recs = [r for k, v in ctx.trace.ops.items()
            if k.startswith("Optimizer.step#") for r in v]
    if not recs:
        return None
    return sum(r["end"] - r["start"] for r in recs) * 1e3 / len(ctx.units)
