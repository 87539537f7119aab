"""The arithmetic of the metrics: a percentile with its sample count, a
rate over a window, the union of intervals."""

from __future__ import annotations

import math


def percentile(values, q):
    """The nearest-rank ``q``-th percentile of ``values`` and the number of
    samples above it: the smallest value with at least q % of the samples
    at or below it. Raises on no samples."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no samples")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1], len(xs) - rank


def rate(work, seconds):
    """Work per second over a window that ran ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
