"""device_idle_share (%): the share of the traced window in which no
operation ran on the device, 100 · (1 − busy / window), averaged over the
ranks. Busy is the union of the device's intervals in the profiler's
trace; nothing to read where no operation ran on the device."""

import statistics


def read(summaries):
    vals = [100.0 * (1.0 - s["busy_s"] / s["window_s"]) for s in summaries
            if s["window_s"] > 0 and s["busy_s"] > 0]
    return statistics.fmean(vals) if vals else None
