"""Replays of the image branch's CUDA graphs a request: the program's
``pvn3d.image_graph.replay`` ranges inside its ``pvn3d.request#<n>``
ranges on the same thread (``pvn3d_tpu_torch/utils/graphs.py``).  1 a
PVN3D request and 8 an FFB6D request where the graphs engage, 0 where
they are bypassed."""


def _ranges(ctx, prefix):
    return [r for k, v in ctx.trace.ops.items() if k.startswith(prefix)
            for r in v]


def read(ctx):
    reqs = _ranges(ctx, "pvn3d.request#")
    if not reqs:
        return None
    n = sum(any(q["tid"] == r["tid"] and q["start"] <= r["start"]
                and r["end"] <= q["end"] for q in reqs)
            for r in _ranges(ctx, "pvn3d.image_graph.replay"))
    return n / len(reqs)
