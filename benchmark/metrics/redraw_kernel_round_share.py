"""redraw_kernel_round_share (%): the share of the postselection redraw
rounds in the traced stretch that took the model's one-launch round (the
smear, the validity test and the merge of the rows still invalid in one
kernel): 100 × the program's counter
``resamplers.LiuWestResampler.kernel_rounds`` over
``resamplers.LiuWestResampler.redraw_rounds``, from
``qinfer_tpu_torch.profiling.recorded()``. Nothing to read where the
program has no such counter or ran no redraw round in the stretch."""

KERNEL = "resamplers.LiuWestResampler.kernel_rounds"
ROUNDS = "resamplers.LiuWestResampler.redraw_rounds"


def value(rec):
    """The metric of one recorded stretch (``profiling.recorded()``)."""
    kernel = rec["counters"].get(KERNEL, 0)
    rounds = rec["counters"].get(ROUNDS, 0)
    if kernel <= 0 or rounds <= 0:
        return None
    return 100.0 * kernel / rounds


def read(summaries):
    del summaries  # the program keeps its own record of the stretch
    try:
        from qinfer_tpu_torch.profiling import recorded
    except ImportError:  # a program without spans
        return None
    return value(recorded())
