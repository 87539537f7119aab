"""The numbers that decide ``correct``: each with its limit.

A driver's ``check`` returns ``Check``s; the run is correct when every
number is at or below its limit (a number that is not finite fails).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    items: int  # answers compared
    failed: int  # of them, those over the limit

    @property
    def ok(self):
        return math.isfinite(self.value) and self.value <= self.limit


def worst(name, values, limit):
    """The widest of ``values`` against ``limit``."""
    vals = [float(v) for v in values]
    bad = sum(not (math.isfinite(v) and v <= limit) for v in vals)
    if not vals:
        return Check(name, math.nan, limit, 0, 0)
    top = max(vals, key=lambda v: v if math.isfinite(v) else math.inf)
    return Check(name, top, limit, len(vals), bad)


def quantile(name, values, q, limit):
    """The nearest-rank ``q``-th percentile of ``values`` against
    ``limit``: a number steady from run to run where the widest swings
    with the rare answer that the algorithm itself gets wrong."""
    vals = sorted(float(v) if math.isfinite(v) else math.inf for v in values)
    if not vals:
        return Check(name, math.nan, limit, 0, 0)
    top = vals[max(1, math.ceil(q / 100.0 * len(vals))) - 1]
    return Check(name, top, limit, len(vals),
                 sum(not v <= limit for v in vals))


def median(name, values, limit):
    return quantile(name, values, 50, limit)
