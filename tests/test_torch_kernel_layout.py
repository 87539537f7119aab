"""Which layout path and form each kernel launch takes, decided on the host.

B1 (``ops.fused_update``) reads its parameter columns by row spans when
they are views of one row-major (…, N, s) bank with s ≥ 8 (``_row_span``
returns the row stride and each column's offset in the row), and column
by column otherwise; the per-column path runs in one launch or in two
passes (``grid_plan``, from T, N and the card's resident capacity). B2
(``ops.resample_expand``) picks its form from D. These choices are made
from shapes, strides, pointers and one queried number alone, so they are
tested here on CPU tensors (the wrapper's arguments to the kernel through
a stand-in library); the kernels themselves run in ``test_torch_gpu.py``.
"""

import contextlib
import ctypes

import pytest
import torch

from qinfer_tpu_torch import _build

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


@pytest.mark.parametrize("d,form", [(1, b2.MERGE), (2, b2.MERGE),
                                    (4, b2.MERGE), (5, b2.MERGE),
                                    (8, b2.MERGE), (9, b2.SPAN),
                                    (16, b2.SPAN), (17, b2.SPAN)])
def test_expand_form_by_width(d, form):
    assert b2.kernel_form(d, 2 << 20) == form


@pytest.mark.parametrize("n_trials,n,d,form", [
    (1, 1 << 20, 1, b2.MERGE),    # the flagship's resample
    (1, 1 << 20, 4, b2.MERGE),    # config 5's
    (4, 1 << 18, 1, b2.MERGE),    # ensemble_big's, every trial
    (1, 1 << 18, 1, b2.MERGE),    # ensemble_big's median resample
    (256, 2048, 1, b2.MERGE),
    (74, 2048, 1, b2.ROWS),       # ensemble_small's median resample
    (1, 16385, 1, b2.ROWS),
    (74, 2048, 16, b2.SPAN),
])
def test_expand_form_by_launch_size(n_trials, n, d, form):
    """The merge path from 2^19 merged items (T·(n_in + n_out)), one thread
    a row on fewer, the span form above D = 8 at any size."""
    assert b2.kernel_form(d, n_trials * 2 * n) == form


# -- B1's forms: one launch or two passes ----------------------------------------

SHAPES = [(1, 1000), (1, (1 << 20) + 3), (1, 1 << 20), (256, 2048),
          (4, 1 << 18), (3, 1003), (1, 1 << 22), (1, (1 << 22) + 1)]
# Resident capacities of an H100's 132 SMs at 8, 6, 4 and 3 blocks an SM,
# and one too small for the one-launch form at 2^20.
CAPACITIES = [1056, 792, 528, 396, 64]


def _two_pass_blocks(n):
    """The two-pass grid's blocks a trial, as before the one-launch form."""
    return max(1, min(1024, -(-n // 1024)))


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("n_trials,n", SHAPES)
def test_grid_plan(n_trials, n, capacity):
    plan = b1.grid_plan(n_trials, n, capacity)
    assert plan.n_blocks == _two_pass_blocks(n)
    assert plan.per_thread == -(-n // (plan.n_blocks * 256))
    if plan.form == b1.TWO_PASS:
        assert (plan.blocks, plan.per_block) == (plan.n_blocks, 1)
        return
    assert plan.form == b1.ONE_LAUNCH
    assert plan.blocks * plan.per_block >= plan.n_blocks
    assert (plan.blocks - 1) * plan.per_block < plan.n_blocks  # no idle block
    assert plan.per_block * plan.per_thread <= 16
    assert plan.blocks == 1 or n_trials * plan.blocks <= capacity // 2


@pytest.mark.parametrize("n_trials,n,capacity,form,blocks", [
    (1, 1000, 1, b1.ONE_LAUNCH, 1),          # one block: no barrier
    (3, 1003, 1, b1.ONE_LAUNCH, 1),
    (256, 2048, 1056, b1.ONE_LAUNCH, 1),     # ensemble_small: a block a trial
    (256, 2048, 64, b1.ONE_LAUNCH, 1),
    (1, 1 << 20, 1056, b1.ONE_LAUNCH, 512),  # half the capacity at most
    (1, 1 << 20, 528, b1.ONE_LAUNCH, 256),
    (1, (1 << 20) + 3, 1056, b1.ONE_LAUNCH, 512),
    (1, (1 << 20) + 3, 792, b1.ONE_LAUNCH, 342),
    (4, 1 << 18, 1056, b1.ONE_LAUNCH, 128),  # ensemble_big
    (1, 1 << 20, 396, b1.TWO_PASS, 1024),    # the card holds too few blocks
    (4, 1 << 18, 64, b1.TWO_PASS, 256),
    (1, (1 << 22) + 1, 1056, b1.TWO_PASS, 1024),  # 17 log-weights a thread
])
def test_grid_plan_picks(n_trials, n, capacity, form, blocks):
    plan = b1.grid_plan(n_trials, n, capacity)
    assert (plan.form, plan.blocks) == (form, blocks)


def test_forced_forms():
    """TWO_PASS is always taken; ONE_LAUNCH where the capacity is too small
    keeps the grid of most virtual blocks a block (the card refuses its
    cooperative launch), and raises where a thread would hold more than 16
    log-weights."""
    plan = b1.grid_plan(1, 2048, 1056, form=b1.TWO_PASS)
    assert (plan.form, plan.blocks) == (b1.TWO_PASS, 2)
    plan = b1.grid_plan(1, 1 << 20, 64, form=b1.ONE_LAUNCH)
    assert (plan.form, plan.blocks, plan.per_block) == (b1.ONE_LAUNCH, 256, 4)
    assert plan.blocks > 64
    with pytest.raises(ValueError, match="at most 16"):
        b1.grid_plan(1, (1 << 22) + 1, 1056, form=b1.ONE_LAUNCH)
    with pytest.raises(ValueError, match="unknown B1 form"):
        b1.grid_plan(1, 1000, 1056, form="three_pass")


class _FakeLib:
    """Stands in for the kernel library: records qt_fused_update's
    arguments, writes 1.0 to every log-weight and lse = 0.25 to the
    stats, and reports ``capacity`` blocks."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.calls = []

    def qt_fused_update_capacity(self, outcome, pr1, n_cols, n_trials, cap):
        cap._obj.value = self.capacity
        return 0

    def qt_fused_update(self, *args):
        names = ("out", "n_blocks", "stats", "n", "n_trials", "grid_blocks",
                 "normalize")
        call = dict(zip(names, args[14:15] + args[16:22]))
        call.update(outcome=args[0], pr1=args[1], scalar_stride=args[3],
                    n_cols=args[9])
        n_trials, n = call["n_trials"], call["n"]
        ones = torch.ones(n_trials * n)
        ctypes.memmove(call["out"], ones.data_ptr(), 4 * ones.numel())
        stats = torch.full((n_trials * 4,), 0.25)
        ctypes.memmove(call["stats"], stats.data_ptr(), 4 * stats.numel())
        self.calls.append(call)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib(528)
    monkeypatch.setattr(_build, "library", lambda: (lib, {}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda _: _Stream())
    b1._capacity.cache_clear()
    yield lib
    b1._capacity.cache_clear()


@pytest.mark.parametrize("n_trials,n", [(1, 1000), (1, 1 << 20), (4, 1 << 18),
                                        (256, 2048)])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("form", [None, b1.ONE_LAUNCH, b1.TWO_PASS])
def test_wrapper_passes_its_plan(fake_lib, n_trials, n, normalize, form):
    """The wrapper launches the plan's form and grid; the one-launch form
    returns the kernel's output as it is (normalised there, or raw for
    ``return_stats``), the two-pass form subtracts lse itself when asked."""
    tile = b1.two_outcome_tile(b1.precession_pr1)
    lw = torch.zeros((n_trials, n))
    cols = (torch.zeros((n_trials, n)),)
    out, lse, _, _ = b1._fused_update_cuda(
        tile, torch.zeros((n_trials, 2)), lw, cols, form=form,
        normalize=normalize)
    call, = fake_lib.calls
    plan = b1.grid_plan(n_trials, n, 528, form)
    assert call["n_blocks"] == plan.n_blocks == _two_pass_blocks(n)
    one = plan.form == b1.ONE_LAUNCH
    assert call["grid_blocks"] == (plan.blocks if one else 0)
    assert call["normalize"] == int(normalize)
    assert torch.equal(lse, torch.full((n_trials,), 0.25))
    expect = 0.75 if normalize and not one else 1.0
    assert torch.equal(out, torch.full((n_trials, n), expect))


def test_row_span_keeps_two_passes(fake_lib):
    tile = b1.binomial_tile(b1.make_born_pr1(16))
    bank = torch.zeros((1, 4096, 16))
    cols = tuple(bank[..., j] for j in range(16))
    b1._fused_update_cuda(tile, torch.zeros((1, 19)), torch.zeros((1, 4096)),
                          cols, normalize=True)
    assert fake_lib.calls[0]["grid_blocks"] == 0
    with pytest.raises(ValueError, match="two-pass form only"):
        b1._fused_update_cuda(tile, torch.zeros((1, 19)),
                              torch.zeros((1, 4096)), cols,
                              form=b1.ONE_LAUNCH)


def test_each_tile_launches_from_its_library(fake_lib, monkeypatch):
    """A built-in functor launches from the built-in library by its id, a
    user functor from the library built of its source as functor 0, and
    the column route's GivenPr1 (id 9) from the built-in library, with the
    composition's head of the scalars and the pr1 as its one column."""
    user_lib, sources = _FakeLib(528), []

    def user_library(source):
        sources.append(source)
        return user_lib, {}

    monkeypatch.setattr(_build, "user_library", user_library)
    lw, bank = torch.zeros((1, N)), torch.rand((1, N, 2))
    cols = (bank[..., 0], bank[..., 1])
    scal = torch.tensor([[1.0, 7.3]])

    def pr1(scalars, off, w, v):
        return v * w * scalars[off]

    src = "struct UserPr1 {};"
    b1._fused_update_cuda(b1.two_outcome_tile(b1.cuda_pr1(pr1, src)), scal,
                          lw, cols)
    (call,) = user_lib.calls
    assert (call["outcome"], call["pr1"], call["n_cols"]) == (0, 0, 2)
    assert set(sources) == {src}
    b1._fused_update_cuda(b1.binomial_tile(b1.precession_pr1),
                          torch.zeros((1, 4)), lw, cols[:1])
    twin = b1.two_outcome_tile(pr1)
    tile, scal_g, cols_g, route = b1._route(twin, scal, cols, lw.shape,
                                            batched=True)
    assert route == "column"
    b1._fused_update_cuda(tile, scal_g, lw, cols_g)
    builtin, given = fake_lib.calls
    assert (builtin["outcome"], builtin["pr1"]) == (1, 0)
    assert (given["outcome"], given["pr1"], given["scalar_stride"],
            given["n_cols"]) == (0, 9, 1, 1)
    assert torch.equal(cols_g[0], pr1(scal.T[:, :, None], 1, *cols))
