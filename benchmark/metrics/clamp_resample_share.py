"""clamp_resample_share (%): the share of the traced stretch's Liu–West
resamples whose redraw rounds ran out with rows still invalid, so that the
clamp (``model.canonicalize`` on those rows) ran: 100 × the program's
counter ``resamplers.LiuWestResampler.clamped_resamples`` over the calls of
its span ``qinfer.resamplers.postselect`` (one a resample), from
``qinfer_tpu_torch.profiling.recorded()``. It reads 0 where no resample
clamped. Nothing to read where the program does not count such resamples
or did not resample in the stretch."""

CLAMPED = "resamplers.LiuWestResampler.clamped_resamples"
RESAMPLES = "qinfer.resamplers.postselect"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    resamples = rec["spans"].get(RESAMPLES, {}).get("count", 0)
    if resamples <= 0:
        return None
    return 100.0 * rec["counters"].get(CLAMPED, 0) / resamples


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
        from qinfer_tpu_torch.resamplers import LiuWestResampler
    except ImportError:  # a program without spans
        return None
    if not hasattr(LiuWestResampler, "clamped_resamples"):
        return None  # a program that does not count them
    return value(recorded())
