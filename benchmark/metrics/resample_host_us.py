"""resample_host_us (us/step): the host's time a step in the Liu–West
resample outside its blocking reads (the moments and Σ^{1/2}, the pick
with kernel B2's wrappers, the smear and postselection's draws, the
write-back): the self time of the program's spans
``qinfer.resamplers.*`` and ``qinfer.ops.b2`` in the traced stretch
(``qinfer_tpu_torch.profiling.recorded()``) over its steps (the program's
counter ``smc.steps``). Nothing to read where the program has no such
spans or made no step in the stretch."""

PREFIX = "qinfer.resamplers."
SPANS = ("qinfer.ops.b2",)


def matches(name):
    """Whether this metric reads the span ``name``."""
    return name.startswith(PREFIX) or name in SPANS


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    steps = rec["counters"].get("smc.steps", 0)
    spans = [a for name, a in rec["spans"].items() if matches(name)]
    if steps <= 0 or not spans:
        return None
    return sum(a["self_ns"] for a in spans) / 1e3 / steps


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
