"""postselect_rounds_per_resample (rounds): the Liu–West resampler's
postselection redraw rounds in the traced stretch (the program's counter
``LiuWestResampler.redraw_rounds``) over the resamples in it. Nothing to
read where nothing resampled."""

import statistics


def read(summaries):
    vals = [s["counters"]["redraw_rounds"] / s["counters"]["resamples"]
            for s in summaries if s["counters"].get("resamples", 0) > 0]
    return statistics.fmean(vals) if vals else None
