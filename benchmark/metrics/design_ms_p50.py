"""design_ms_p50 (ms): the median over the traced stretch's steps of the
benchmark's own span from the end of the update on the device to the
chosen effect's index (the information gain of every candidate and its
argmax), timed by CUDA events."""

import statistics


def read(summaries):
    vals = [v for s in summaries for v in s["counters"].get("design_ms", [])]
    return statistics.median(vals) if vals else None
