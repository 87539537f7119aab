"""b1_wide_update_share (%): the share of the traced stretch's SMC steps
whose Bayes update ran kernel B1 on a tile of more than 16 columns (the
three-qubit Born tile): 100 × the program's counter
``ops.fused_bayes_update.wide_launches`` over ``smc.steps``, from
``qinfer_tpu_torch.profiling.recorded()``. It reads 100 where every update
ran B1 and 0 where the updates fell off the kernel. Nothing to read where
the program does not count wide launches or made no step in the stretch."""

WIDE = "ops.fused_bayes_update.wide_launches"
STEPS = "smc.steps"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    steps = rec["counters"].get(STEPS, 0)
    if steps <= 0:
        return None
    return 100.0 * rec["counters"].get(WIDE, 0) / steps


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.ops.fused_update import fused_bayes_update
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    if not hasattr(fused_bayes_update, "wide_launches"):
        return None  # a program that does not count them
    return value(recorded())
