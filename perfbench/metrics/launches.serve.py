"""Device records (kernels, copies, sets) a request launches: those whose
launch lies inside a ``pvn3d.request#<n>`` range on the same thread."""

import bisect
import collections


def read(ctx):
    reqs = [r for k, v in ctx.trace.ops.items()
            if k.startswith("pvn3d.request#") for r in v]
    if not reqs:
        return None
    ats = collections.defaultdict(list)
    for d in ctx.trace.device:
        if d["at"] is not None:
            ats[d["tid"]].append(d["at"])
    for v in ats.values():
        v.sort()
    n = 0
    for q in reqs:
        a = ats.get(q["tid"], [])
        n += bisect.bisect_right(a, q["end"]) - bisect.bisect_left(
            a, q["start"])
    return n / len(reqs)
