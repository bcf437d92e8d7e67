"""Arithmetic over all the samples of a window: percentiles, rates and
the union of busy intervals.

Every statistic here is taken over every sample it is given: a tail is the
tail of all requests, never a median of chunk medians, and a rate is all
the work over all the time.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of all ``values``, linear between
    order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return work / seconds


def union_seconds(intervals: Sequence[tuple]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total = 0.0
    end = -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
