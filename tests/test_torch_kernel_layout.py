"""Which layout path each kernel launch takes, decided on the host.

B1 (``ops.fused_update``) reads its parameter columns by row spans when
they are views of one row-major (…, N, s) bank with s ≥ 8 (``_row_span``
returns the row stride and each column's offset in the row), and column
by column otherwise. B2 (``ops.resample_expand``) picks its form from D.
Both choices are made from shapes, strides and pointers alone, so they
are tested here on CPU tensors; the kernels themselves run in
``test_torch_gpu.py``.
"""

import pytest
import torch

from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import resample_expand as b2

N = 1000


def _views(bank, cols):
    return tuple(bank[..., j] for j in cols)


@pytest.mark.parametrize("s,cols,offsets", [
    (16, range(16), list(range(16))),  # two-qubit Born bank
    (17, range(16), list(range(16))),  # diffusive two qubits: ε unread
    (8, range(8), list(range(8))),     # multicos with 8 terms
    (17, range(1, 17), list(range(16))),  # columns 1…16: base is column 1
    (16, (2, 0, 3), [2, 0, 3]),        # out of order
])
def test_views_of_one_bank_take_the_row_span(s, cols, offsets):
    bank = torch.rand((N, s))
    assert b1._row_span(_views(bank, cols)) == (s, offsets)


@pytest.mark.parametrize("s,cols,offsets", [
    (4, range(4), [0, 1, 2, 3]),       # config 5
    (5, range(4), [0, 1, 2, 3]),       # diffusive qubit: ε unread
    (2, range(2), [0, 1]),             # multicos
    (3, range(3), [0, 1, 2]),          # RB
    (5, range(1, 5), [0, 1, 2, 3]),    # columns 1…4
])
def test_narrow_rows_keep_the_per_column_path(s, cols, offsets):
    """Below a row stride of 8 the wrapper keeps the per-column path (it
    measured faster there); the layout still qualifies when forced."""
    bank = torch.rand((N, s))
    assert b1._row_span(_views(bank, cols)) is None
    assert b1._row_span(_views(bank, cols), min_stride=2) == (s, offsets)


@pytest.mark.parametrize("s,k", [(16, 16), (17, 16), (5, 4), (4, 4)])
def test_offset_view_keeps_its_stride_and_offsets(s, k):
    """bank[1:] starts one row (s floats) in: same stride and offsets."""
    bank = torch.rand((N + 1, s))[1:]
    assert b1._row_span(_views(bank, range(k)), min_stride=2) == (
        s, list(range(k)))
    assert (b1._row_span(_views(bank, range(k))) is not None) == (s >= 8)


@pytest.mark.parametrize("s,k", [(16, 16), (17, 16), (4, 4), (2, 2)])
def test_batched_views_share_the_trial_stride(s, k):
    """(T, N) views of a (T, N, s) bank share the trial stride N·s; as the
    wrapper passes one bank, (1, N) views of an (N, s) bank do too."""
    bank = torch.rand((3, N, s))
    cols = _views(bank, range(k))
    assert cols[0].stride() == (N * s, s)
    assert b1._row_span(cols, min_stride=2) == (s, list(range(k)))
    single = tuple(c[None] for c in _views(bank[0], range(k)))
    assert b1._row_span(single, min_stride=2) == (s, list(range(k)))


def test_copies_take_the_per_column_path():
    bank = torch.rand((N, 16))
    cols = _views(bank, range(16))
    assert b1._row_span(tuple(c.contiguous() for c in cols), 2) is None
    every_other = tuple(c.contiguous() if j % 2 == 0 else c
                        for j, c in enumerate(cols))
    assert b1._row_span(every_other, 2) is None
    batched = _views(torch.rand((3, N, 4)), range(4))
    assert b1._row_span(tuple(c.contiguous() for c in batched), 2) is None


@pytest.mark.parametrize("case", ["one_column", "wide_stride", "two_banks",
                                  "trial_strides", "column_stride"])
def test_other_layouts_take_the_per_column_path(case):
    if case == "one_column":  # a single column is read coalesced as it is
        cols = (torch.rand((N, 4))[:, 0],)
    elif case == "wide_stride":  # s > 20: two stages exceed 48 KB
        cols = _views(torch.rand((N, 21)), range(4))
    elif case == "two_banks":
        cols = (_views(torch.rand((N, 4)), range(2))
                + _views(torch.rand((N, 4)), range(2)))
    elif case == "trial_strides":  # one trial stride is required
        a, b = torch.rand((3, N, 4)), torch.rand((3, 2 * N, 4))[:, :N]
        cols = (a[..., 0], b[..., 1])
    else:  # a column of a column-major bank: rows are not contiguous
        cols = _views(torch.rand((4, N)).T, range(4))
    assert b1._row_span(cols, min_stride=2) is None


def test_more_columns_than_the_row_stride():
    """s ≥ the number of columns: a column read twice in a row of 2."""
    bank = torch.rand((N, 2))
    assert b1._row_span((bank[:, 0], bank[:, 1], bank[:, 0]), 2) is None


@pytest.mark.parametrize("d,form", [(1, b2.ROWS), (2, b2.ROWS),
                                    (4, b2.ROWS), (5, b2.ROWS),
                                    (8, b2.ROWS), (9, b2.SPAN),
                                    (16, b2.SPAN), (17, b2.SPAN)])
def test_expand_form_by_width(d, form):
    assert b2.kernel_form(d) == form
