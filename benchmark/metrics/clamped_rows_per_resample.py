"""clamped_rows_per_resample (rows): the rows that the Liu–West resample
projected onto the valid set after its last redraw round in the traced
stretch (the program's counter
``resamplers.LiuWestResampler.clamped_rows``, 0 where it did not grow)
over its resamples (the calls of the program's span
``qinfer.resamplers.postselect``, one a resample), from
``qinfer_tpu_torch.profiling.recorded()``. Nothing to read where the
program does not count the rows it tests (``tested_rows``: a program
without these counters) or did not resample in the stretch."""

CLAMPED = "resamplers.LiuWestResampler.clamped_rows"
TESTED = "resamplers.LiuWestResampler.tested_rows"
RESAMPLES = "qinfer.resamplers.postselect"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    resamples = rec["spans"].get(RESAMPLES, {}).get("count", 0)
    if rec["counters"].get(TESTED, 0) <= 0 or resamples <= 0:
        return None
    return rec["counters"].get(CLAMPED, 0) / resamples


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
