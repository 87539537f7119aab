"""b2_roofline (%): kernel B2's share of its roofline. The least time of
the traced stretch's systematic expands (bytes that the cell's module
under ``drivers/`` counts from the resamples made and their shapes,
``harness.roofline.b2_bytes``, over the chip's bandwidth) over the device
time of B2's kernels in the trace; averaged over the ranks. Nothing to
read where no B2 kernel ran."""

import statistics

from harness import roofline
from harness.trace import matching

KERNELS = ("expand_rows", "expand_span", "expand_merge", "expand_bank")


def read(summaries):
    vals = []
    for s in summaries:
        us, calls = matching(s, KERNELS)
        nbytes = s["counters"].get("b2_bytes", 0)
        if calls and us > 0 and nbytes > 0:
            least = roofline.least_seconds(nbytes)
            vals.append(100.0 * least / (us * 1e-6))
    return statistics.fmean(vals) if vals else None
