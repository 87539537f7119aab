"""step_host_us (us/step): the host's time a step in the SMC step's own
code, the Bayes update's included, outside its kernels' wrappers, its
resample and its blocking reads: the self time of the program's spans
``qinfer.smc.step`` and ``qinfer.smc.update`` in the traced stretch
(``qinfer_tpu_torch.profiling.recorded()``) over its steps (the program's
counter ``smc.steps``). Nothing to read where the program has no such
spans or made no step in the stretch."""

SPANS = ("qinfer.smc.step", "qinfer.smc.update")


def matches(name):
    """Whether this metric reads the span ``name``."""
    return name in SPANS


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
