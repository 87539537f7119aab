"""valid_kernel_row_share (%): the share of the rows put through a validity
test in the traced stretch that the program's one-launch validity kernel
tested: 100 × the program's counter ``ops.psd_valid.rows`` over
``resamplers.LiuWestResampler.tested_rows``, from
``qinfer_tpu_torch.profiling.recorded()``. Nothing to read where the
program has no such kernel (no ``ops.psd_valid.rows``) or tested no rows
in the stretch."""

KERNEL = "ops.psd_valid.rows"
TESTED = "resamplers.LiuWestResampler.tested_rows"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    rows = rec["counters"].get(KERNEL, 0)
    tested = rec["counters"].get(TESTED, 0)
    if rows <= 0 or tested <= 0:
        return None
    return 100.0 * rows / tested


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
