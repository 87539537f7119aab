"""valid_rows_per_resample (rows): the rows that the Liu–West resample put
through a validity test in the traced stretch (the program's counter
``resamplers.LiuWestResampler.tested_rows``: the drawn bank and every
redraw round's) over its resamples (the calls of the program's span
``qinfer.resamplers.postselect``, one a resample), from
``qinfer_tpu_torch.profiling.recorded()``. Nothing to read where the
program has no such counter or did not resample in the stretch."""

TESTED = "resamplers.LiuWestResampler.tested_rows"
RESAMPLES = "qinfer.resamplers.postselect"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    rows = rec["counters"].get(TESTED, 0)
    resamples = rec["spans"].get(RESAMPLES, {}).get("count", 0)
    if rows <= 0 or resamples <= 0:
        return None
    return rows / resamples


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
