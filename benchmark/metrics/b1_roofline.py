"""b1_roofline (%): kernel B1's share of its roofline. The least time of
the traced stretch's Bayes updates (bytes that the cell's module under
``drivers/`` counts from the cell's shapes and updates,
``harness.roofline.b1_bytes``, over the chip's bandwidth) over the device
time of B1's kernels in the trace; averaged over the ranks. Nothing to
read where no B1 kernel ran."""

import statistics

from harness import roofline
from harness.trace import matching

KERNELS = ("fused_update_one", "fused_update_pass1", "fused_update_pass2",
           "fused_update_span")


def read(summaries):
    vals = []
    for s in summaries:
        us, calls = matching(s, KERNELS)
        nbytes = s["counters"].get("b1_bytes", 0)
        if calls and us > 0 and nbytes > 0:
            least = roofline.least_seconds(nbytes)
            vals.append(100.0 * least / (us * 1e-6))
    return statistics.fmean(vals) if vals else None
