"""valid_host_us (us/step): the host's time a step in the Liu–West
resample's validity tests (``model.are_models_valid`` on every drawn bank
and every redraw round of postselection): the time of the program's span
``qinfer.resamplers.valid`` in the traced stretch
(``qinfer_tpu_torch.profiling.recorded()``) over its steps (the program's
counter ``smc.steps``). A part of ``resample_host_us``, which counts the
same span's self time among the resample's: not a further share of the
step. Nothing to read where the program has no such span or made no step
in the stretch."""

SPANS = ("qinfer.resamplers.valid",)


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    steps = rec["counters"].get("smc.steps", 0)
    spans = [a for name, a in rec["spans"].items() if name in SPANS]
    if steps <= 0 or not spans:
        return None
    return sum(a["total_ns"] for a in spans) / 1e3 / steps


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
