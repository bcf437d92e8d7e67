"""Host ms a request spends in FFB6D's bidirectional fusion: the
program's ``pvn3d.fusion`` ranges (``models/ffb6d.py::FFB6D.fuse``, both
directions of each of the seven stages).  A program without them reads
nothing."""


def read(ctx):
    recs = ctx.trace.ops.get("pvn3d.fusion", [])
    if not recs:
        return None
    return sum(r["end"] - r["start"] for r in recs) * 1e3 / len(ctx.units)
