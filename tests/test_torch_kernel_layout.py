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

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import _build

from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import pr1_trace
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
    (64, range(64), list(range(64))),  # three-qubit Born bank
    (40, range(20), list(range(20))),  # a wide tile in a wider bank
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
                                  "trial_strides", "column_stride",
                                  "wide_tile_stride"])
def test_other_layouts_take_the_per_column_path(case):
    if case == "one_column":  # a single column is read coalesced as it is
        cols = (torch.rand((N, 4))[:, 0],)
    elif case == "wide_stride":  # s > 20 for ≤ 16 columns: slower on the span
        cols = _views(torch.rand((N, 21)), range(4))
    elif case == "wide_tile_stride":  # s > 64: the diffusive three qubits
        cols = _views(torch.rand((N, 65)), range(64))
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
    assert b2.kernel_form(d, 1, 1 << 20, 1 << 20) == form


@pytest.mark.parametrize("n_trials,n,d,form", [
    (1, 1 << 20, 1, b2.MERGE),    # the flagship's resample
    (1, 1 << 20, 4, b2.MERGE),    # config 5's
    (4, 1 << 18, 1, b2.MERGE),    # ensemble_big's, every trial
    (1, 1 << 18, 1, b2.MERGE),    # ensemble_big's median resample
    (256, 2048, 1, b2.BANK),      # every trial of ensemble_small
    (74, 2048, 1, b2.BANK),       # ensemble_small's median resample
    (1, 16385, 1, b2.ROWS),
    (74, 2048, 16, b2.SPAN),
])
def test_expand_form_by_launch_size(n_trials, n, d, form):
    """The bank form on banks of up to 2048 at any T, the merge path from
    2^19 merged items (T·(n_in + n_out)) on the rest, the bank form below
    that on banks of up to 12288, one thread a row above, the span form
    above D = 8 at any size."""
    assert b2.kernel_form(d, n_trials, n, n) == form


@pytest.mark.parametrize("n", [2000, 4000, 5000, 10000])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_examples_banks_take_the_bank_form(n, d):
    """The examples' own N (the random walk and the die 2000, config 5
    4000, configs 1 and 4 PGH 5000, two-qubit tomography 10000) at D ≤ 8."""
    assert b2.kernel_form(d, 1, n, n) == b2.BANK


@pytest.mark.parametrize("n_trials,n_in,n_out,form", [
    (1, 1 << 20, 1 << 18, b2.MERGE),     # a rank's window of a bank over 4
    (1024, 2048, 2048, b2.BANK),         # measured faster than the merge path
    (3, 10000, 10000, b2.BANK),
    (1, b2.BANK_FEW, b2.BANK_FEW, b2.BANK),
    (1, b2.BANK_FEW + 1, b2.BANK_FEW + 1, b2.ROWS),
    (1, 1 << 15, 1 << 13, b2.ROWS),      # a shifted window over BANK_FEW
    (1, 1 << 17, 1 << 17, b2.ROWS),      # a single bank between bank and merge
    (64, 4096, 4096, b2.MERGE),          # 2^19 merged items
])
def test_expand_form_at_the_edges(n_trials, n_in, n_out, form):
    assert b2.kernel_form(1, n_trials, n_in, n_out) == form


@pytest.mark.parametrize("n_trials,n_out,tiles", [
    (1, 2000, 8), (1, 5000, 20), (1, 10000, 40),  # searched tiles of 256 rows
    (16, 2048, 8), (33, 2048, 8),                 # ≤ 264 searched tiles
    (34, 2048, 1), (74, 2048, 1), (256, 2048, 1),  # a scanned block a bank
    (34, 4099, 3),
])
def test_bank_tiles(n_trials, n_out, tiles):
    assert b2.bank_tiles(n_trials, n_out) == tiles


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

    def qt_expand(self, *args):
        names = ("n_in", "n_cols", "n_out", "n_trials", "form", "tiles")
        self.calls.append(dict(zip(names, args[1:2] + args[3:4]
                                   + args[6:10])))
        return 0

    def qt_liu_west_expand(self, *args):
        names = ("n", "n_cols", "a", "one_minus_a", "h2", "zero_cov")
        call = dict(zip(names, args[1:2] + args[3:4] + args[5:9]))
        call.update(root=args[12] is not None, n_trials=args[13])
        self.calls.append(call)
        return 0

    def qt_fused_update(self, *args):
        names = ("out", "n_blocks", "stats", "n", "n_trials", "grid_blocks",
                 "normalize")
        call = dict(zip(names, args[14:15] + args[16:22]))
        call.update(outcome=args[0], pr1=args[1], scalar_stride=args[3],
                    n_cols=args[9], span_stride=args[12])
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


@pytest.mark.parametrize("n_trials,n,d,form,tiles", [
    (74, 2048, 1, b2.BANK, 1),        # ensemble_small's median resample: a block a bank
    (1, 5000, 1, b2.BANK, 20),        # config 1's own bank: tiles of 256 rows
    (8, 4099, 4, b2.BANK, 17),        # a few banks: tiles of 256 rows
    (40, 4099, 2, b2.BANK, 3),        # many banks: tiles of up to 2048 rows
    (1, 1 << 17, 1, b2.ROWS, 0),
    (256, 4096, 1, b2.MERGE, 0),
    (3, 2048, 16, b2.SPAN, 0),
])
def test_expand_wrappers_launch_their_form(fake_lib, n_trials, n, d, form,
                                           tiles):
    """Both B2 wrappers pass ``kernel_form``'s form and the bank form's
    tiles to the kernel and count the launch in all and under its form;
    a launch with a forced form counts on neither."""
    starts = torch.zeros((n_trials, n), dtype=torch.int32)
    vals = torch.zeros((n_trials, n, d))
    b2.reset_form_launches()
    b2._expand_cuda_batched(starts, vals, n, None, form=form)
    for wrapper in (b2.expand_sorted_segments,
                    b2.expand_sorted_segments_batched):
        assert b2._launch(wrapper, starts, vals, n, None).shape == vals.shape
    assert len(fake_lib.calls) == 3
    for call in fake_lib.calls:
        assert (call["form"], call["tiles"]) == (form, tiles)
        assert (call["n_in"], call["n_out"], call["n_trials"],
                call["n_cols"]) == (n, n, n_trials, d)
    for wrapper in (b2.expand_sorted_segments,
                    b2.expand_sorted_segments_batched):
        assert wrapper.launches == 1
        assert wrapper.form_launches == {
            name: int(name == b2.FORM_NAMES[form])
            for name in b2.FORM_NAMES.values()}
    b2.reset_form_launches()


@pytest.mark.parametrize("device_type,n,d,use,fused", [
    ("cuda", 2048, 1, None, True),     # the ensembles' banks
    ("cuda", 1, 1, None, True),
    ("cuda", 37, 4, True, True),       # tomography at D = 4
    ("cuda", 2048, 8, None, True),
    ("cuda", 2049, 1, None, False),    # over a block's rows
    ("cuda", 5000, 1, None, False),    # the quickstart's bank
    ("cuda", 1 << 18, 1, None, False),  # ensemble_big
    ("cuda", 2048, 9, None, False),    # over the bank form's columns
    ("cuda", 2048, 1, False, False),   # the expand kernel off
    ("cuda", 0, 1, None, False),
    ("cpu", 2048, 1, None, False),
    ("cpu", 2048, 1, True, False),
])
def test_fused_liu_west_route(device_type, n, d, use, fused):
    """The batched resample's route is a function of the device type, the
    bank's rows and columns and ``use_expand_kernel`` alone: the
    resampler's own choice of kernel B2 (``use_expand_kernel``, or a CUDA
    device when None), then what the kernel takes."""
    resampler = qt.LiuWestResampler(use_expand_kernel=use)
    takes_b2 = resampler._expand_kernel_on(torch.device(device_type))
    assert takes_b2 is (use if use is not None else device_type == "cuda")
    assert (takes_b2 and b2.fused_liu_west_route(device_type, n, d)) is fused


@pytest.mark.parametrize("n_trials,n,d", [(74, 2048, 1), (3, 37, 4),
                                          (1, 1, 8)])
def test_fused_liu_west_passes_its_arguments(fake_lib, n_trials, n, d):
    """The wrapper hands the kernel the bank's shape, a, 1 − a, h² and the
    covariance's floor, and asks for h·Σ^{1/2} at D = 1 only."""
    out, mean, cov, root = b2._liu_west_cuda(
        torch.zeros((n_trials, n)), torch.zeros((n_trials, n, d)),
        torch.zeros(n_trials), 0.98, 0.25, 1e-3)
    assert fake_lib.calls == [{
        "n": n, "n_cols": d, "a": 0.98, "one_minus_a": 1.0 - 0.98,
        "h2": 0.25 * 0.25, "zero_cov": 1e-3, "root": d == 1,
        "n_trials": n_trials}]
    assert out.shape == (n_trials, n, d) and mean.shape == (n_trials, d)
    assert cov.shape == (n_trials, d, d)
    assert (root is None) == (d > 1)
    assert root is None or root.shape == (n_trials, 1, 1)


@pytest.mark.parametrize("n,d,dtype", [(2049, 1, torch.float32),
                                       (2048, 9, torch.float32),
                                       (0, 1, torch.float32),
                                       (64, 1, torch.float64)])
def test_fused_liu_west_refuses_what_it_cannot_take(fake_lib, n, d, dtype):
    with pytest.raises(ValueError):
        b2._liu_west_cuda(torch.zeros((2, n), dtype=dtype),
                          torch.zeros((2, n, d), dtype=dtype),
                          torch.zeros(2, dtype=dtype), 0.98, 0.2, 0.0)
    assert fake_lib.calls == []


def test_fused_liu_west_launches_on_cuda_tensors_only(fake_lib):
    """The wrapper has no CPU branch: a CPU bank takes the resampler's
    eager chain, and the wrapper refuses it before any launch."""
    launches = b2.liu_west_expand_batched.launches
    with pytest.raises(ValueError, match="CUDA"):
        b2.liu_west_expand_batched(torch.zeros((2, 64)),
                                   torch.zeros((2, 64, 1)), torch.zeros(2),
                                   0.98, 0.2)
    assert fake_lib.calls == []
    assert b2.liu_west_expand_batched.launches == launches


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


def test_wide_tile_takes_the_row_span_at_64_columns(fake_lib):
    """The three-qubit Born tile: 64 columns of an (N, 64) bank on the row
    span (two passes); over MAX_COLS the wrapper refuses before any
    launch."""
    tile = b1.binomial_tile(b1.make_born_pr1(64))
    bank = torch.zeros((1, 4096, 64))
    cols = tuple(bank[..., j] for j in range(64))
    b1._fused_update_cuda(tile, torch.zeros((1, 67)), torch.zeros((1, 4096)),
                          cols, normalize=True)
    call, = fake_lib.calls
    assert (call["n_cols"], call["span_stride"], call["grid_blocks"],
            call["pr1"]) == (64, 64, 0, 8)
    wide = torch.zeros((1, 4096, 65))
    with pytest.raises(ValueError, match="at most 64 parameter columns"):
        b1._fused_update_cuda(b1.binomial_tile(b1.make_born_pr1(65)),
                              torch.zeros((1, 68)), torch.zeros((1, 4096)),
                              tuple(wide[..., j] for j in range(65)))
    assert len(fake_lib.calls) == 1


def test_each_tile_launches_from_its_library(fake_lib, monkeypatch):
    """A built-in functor launches from the built-in library by its id, a
    user functor from the library built of its source as functor 0, a
    torch pr1 from the library built of its traced source as functor 0,
    and the column route's GivenPr1 (id 9) from the built-in library, with
    the composition's head of the scalars and the pr1 as its one column."""
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
    tile, _, _, route = b1._route(b1.two_outcome_tile(pr1), scal, cols,
                                  lw.shape, batched=True)
    assert route == "traced"
    b1._fused_update_cuda(tile, scal, lw, cols)
    traced = user_lib.calls[1]
    assert (traced["outcome"], traced["pr1"], traced["n_cols"]) == (0, 0, 2)
    assert sources[-1] == pr1_trace.trace_pr1(pr1, 2).source

    def refused(scalars, off, w, v):  # in place: the tracer refuses it
        return (v * w).mul_(scalars[off])

    tile, scal_g, cols_g, route = b1._route(b1.two_outcome_tile(refused),
                                            scal, cols, lw.shape,
                                            batched=True)
    assert route == "column"
    b1._fused_update_cuda(tile, scal_g, lw, cols_g)
    builtin, given = fake_lib.calls
    assert (builtin["outcome"], builtin["pr1"]) == (1, 0)
    assert (given["outcome"], given["pr1"], given["scalar_stride"],
            given["n_cols"]) == (0, 9, 1, 1)
    assert torch.equal(cols_g[0], pr1(scal.T[:, :, None], 1, *cols))
