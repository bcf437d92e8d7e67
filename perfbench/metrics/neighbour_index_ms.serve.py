"""Host ms a request spends building FFB6D's neighbour index: the
program's ``pvn3d.neighbour_index`` ranges (``inference/pipeline.py``
around ``data/ffb6d_index.py::build_index``).  A program without them
(PVN3D, or before FFB6D) reads nothing."""


def read(ctx):
    recs = ctx.trace.ops.get("pvn3d.neighbour_index", [])
    if not recs:
        return None
    return sum(r["end"] - r["start"] for r in recs) * 1e3 / len(ctx.units)
