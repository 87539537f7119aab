"""Fused Bayes update (kernel B1): wrapper, likelihood tiles, plain version.

Counterpart of ``qinfer_tpu/ops/fused_update.py``. One pass over the bank
computes the likelihood, the log-weight update and both streaming
log-sum-exps (evidence and ESS). On a CUDA tensor ``fused_bayes_update``
launches the hand-written kernels of ``csrc/fused_update.cuh`` (whose note
says what bounds them and how they are laid out); on a CPU tensor it runs
``fused_update_plain``, the same function in plain PyTorch. A failed build
or launch raises, and so does a tile that is neither an outcome
composition nor has a CUDA functor: nothing falls back.

A likelihood tile is an outcome composition (``TwoOutcomeTile``,
``BinomialTile``) over a pr1 function. Both are frozen dataclasses,
callable as the plain PyTorch version, ``tile(scalars, *param_cols) ->
(N,) log L`` and ``pr1(scalars, offset, *param_cols) -> (N,) Pr(1)``.
Each also names its CUDA functor (``outcome_id``, ``functor_id``), and a
pr1 carries the constants that the JAX package bakes into its closure
(``consts``), so the kernel is found by value and ``scalars`` keeps the
JAX layout. The kernel takes at most ``MAX_COLS`` parameter columns, and
every built-in functor takes that many; a wider launch raises, and the SMC
step sends such a tile to the unfused update instead (counted as
``unfused_wide``).

A model's own pr1, as the JAX package traces any ``jnp`` pr1 into its
Pallas kernel, takes one of three routes on CUDA:

- ``cuda_pr1(fn, source, consts)``: ``fn`` is the pr1 in torch (the plain
  version and the CPU route), ``source`` its CUDA functor, a ``struct
  UserPr1`` with the built-in functors' interface
  (``csrc/fused_update.cuh``). The tile launches the same kernels from a
  library of that functor alone, built at first use
  (``_build.user_library``); a source that does not build raises.
- a pr1 in torch alone: traced once (``pr1_trace.trace_pr1``) into a
  ``struct UserPr1`` that computes it op by op as torch does on the card,
  and launched from that source's library as a hand-written functor is:
  the traced route. A generated source that does not build raises.
- a torch pr1 that the tracer refuses (``pr1_trace.Refusal`` says why):
  the column route. The wrapper evaluates the pr1 with torch on the card
  into one (T, N) column and launches the same outcome composition over
  ``GivenPr1``, whose Pr(1) is that column: a few more launches and one
  more round trip of a column through device memory.

Each wrapper counts its launches (``launches``), and of them those on a
user library (``user_launches``), on the traced route
(``traced_launches``), on the column route (``column_launches``) and
those of more than 16 columns (``wide_launches``: the three-qubit Born
tile); ``unfused_wide`` counts the updates that the SMC step gave the
unfused route because their functor's tile is wider than ``MAX_COLS``.

The kernel reads the parameter columns in place, and no column is copied
first. When the columns are views of one row-major (N, s) bank with 8 ≤ s
≤ 20, or s ≤ 64 for a tile of more than 16 columns (``_row_span``), it
stages each block's rows in shared memory with coalesced copies (the
row-span path); otherwise it gets each column's pointer and element stride
(the per-column path). Both give the same bits.

``fused_bayes_update_batched`` updates T independent banks (an ensemble of
trials) in one launch on a (block, trial) grid, on every bank size; its
plain version is ``fused_update_plain_batched``.

The per-column path runs in one of two forms (``grid_plan``): one launch
that keeps each block's log-weights on chip and writes them normalised
once, where a trial's log-weights fit on chip and its blocks fit the
card at once; else two passes and the wrapper's ``lw − lse``. The row span
keeps the two-pass form. Both forms give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, ClassVar, NamedTuple

import torch

from .. import _build
from ..profiling import count, span
from . import pr1_trace

__all__ = [
    "fused_bayes_update", "fused_update_plain",
    "fused_bayes_update_batched", "fused_update_plain_batched",
    "TwoOutcomeTile", "BinomialTile", "two_outcome_tile", "binomial_tile",
    "precession_pr1", "make_multicos_pr1", "make_known_t2_pr1", "rb_pr1",
    "rb_interleaved_pr1", "inversion_pr1", "coin_pr1", "noisy_coin_pr1",
    "make_born_pr1", "given_pr1", "cuda_pr1", "CudaPr1", "MAX_COLS",
    "grid_plan", "ONE_LAUNCH", "TWO_PASS",
]

_LOG_TINY = -87.0
_THREADS = 256  # kThreads in csrc/fused_update.cu
_ITEMS_PER_THREAD = 4
_MAX_BLOCKS = 1024
MAX_COLS = 64  # kMaxCols in csrc/fused_update.cuh
_NARROW_COLS = 16  # kNarrowCols: wider tiles count as wide launches
MAX_TRIALS = 65535  # gridDim.y
_MAX_CONSTS = 4  # kMaxConsts
_MAX_SPAN_STRIDE = 64  # kMaxSpanStride: the row span of a wide tile
# Row strides above this keep the per-column path for tiles of at most 16
# columns: on an H100 at 2^20, 4 to 16 Born columns of banks of stride 21 to
# 64 ran 18 to 31 µs slower on the row span (e.g. 4 of 40: 123.8 against
# 101.4 µs; 16 of 64: 127.6 against 96.8), which stages every column of
# the row to read a few.
_NARROW_SPAN_STRIDE = 20
_HELD = 16  # kHeld: log-weights a thread of the one-launch form keeps
# Row strides below this keep the per-column path. On an H100 at 2^20 the
# tiles with s = 2…5 ran 3.5–5.6 µs slower on the row span, and from s = 8
# to 17 the row span was 10–16 µs faster (chip_profile.py, PERF.md).
_MIN_SPAN_STRIDE = 8


# -- pr1 functions (the ids are the functor switch in qt_fused_update) -------

@dataclass(frozen=True)
class _Pr1:
    functor_id: ClassVar[int]
    consts: ClassVar[tuple] = ()  # compile-time constants of the tile


@dataclass(frozen=True)
class PrecessionPr1(_Pr1):
    """SimplePrecession: 1 − cos²(ωt/2); scalars tail = [t]."""

    functor_id: ClassVar[int] = 0

    def __call__(self, scalars, off, omega):
        c = torch.cos(0.5 * omega * scalars[off])
        return 1.0 - c * c


@dataclass(frozen=True)
class MultiCosPr1(_Pr1):
    """MultiCos: 1 − cos²(ω⃗·t⃗/2); scalars tail = ts (n_terms,)."""

    n_terms: int
    functor_id: ClassVar[int] = 1

    def __call__(self, scalars, off, *omegas):
        arg = omegas[0] * scalars[off]
        for i in range(1, self.n_terms):
            arg = arg + omegas[i] * scalars[off + i]
        c = torch.cos(0.5 * arg)
        return 1.0 - c * c


@dataclass(frozen=True)
class KnownT2Pr1(_Pr1):
    """KnownT2 precession: 1 − (e^{−t/T2}cos²(ωt/2) + (1−e^{−t/T2})/2);
    scalars tail = [t]; T2 is a constant of the tile."""

    t2: float
    functor_id: ClassVar[int] = 2

    @property
    def consts(self):
        return (float(self.t2),)

    def __call__(self, scalars, off, omega):
        t = scalars[off]
        # t2 as a device tensor: a Python scalar divisor would become a
        # multiply by its reciprocal on CUDA; the kernel divides.
        damp = torch.exp(-t / torch.full((), self.t2, device=t.device))
        c = torch.cos(0.5 * omega * t)
        return 1.0 - (damp * c * c + 0.5 * (1.0 - damp))


def _rb_pr1(m, p, A, B):
    decay = torch.exp(m * torch.log(torch.clamp(p, 1e-20, 1.0)))
    return 1.0 - torch.clamp(A * decay + B, 0.0, 1.0)


@dataclass(frozen=True)
class RbPr1(_Pr1):
    """Standard RB: 1 − clip(A·pᵐ + B, 0, 1), pᵐ = exp(m·log(clip(p,
    1e-20, 1))); scalars tail = [m]."""

    functor_id: ClassVar[int] = 3

    def __call__(self, scalars, off, p, A, B):
        return _rb_pr1(scalars[off], p, A, B)


@dataclass(frozen=True)
class RbInterleavedPr1(_Pr1):
    """Interleaved RB: decay p_ref (reference sequence) or p̃·p_ref;
    scalars tail = [m, reference]."""

    functor_id: ClassVar[int] = 4

    def __call__(self, scalars, off, pt, pr_, A, B):
        p_eff = torch.where(scalars[off + 1] == 1.0, pr_, pt * pr_)
        return _rb_pr1(scalars[off], p_eff, A, B)


@dataclass(frozen=True)
class InversionPr1(_Pr1):
    """SimpleInversion (Ramsey): 1 − cos²((ω−ω_)t/2); tail = [w_, t]."""

    functor_id: ClassVar[int] = 5

    def __call__(self, scalars, off, omega):
        c = torch.cos(0.5 * (omega - scalars[off]) * scalars[off + 1])
        return 1.0 - c * c


@dataclass(frozen=True)
class CoinPr1(_Pr1):
    """CoinModel: Pr(1) = p; empty scalar tail."""

    functor_id: ClassVar[int] = 6

    def __call__(self, scalars, off, p):
        return p


@dataclass(frozen=True)
class NoisyCoinPr1(_Pr1):
    """NoisyCoin: Pr(1) = 1 − (α(1−p) + βp); tail = [α, β]."""

    functor_id: ClassVar[int] = 7

    def __call__(self, scalars, off, p):
        return 1.0 - (scalars[off] * (1.0 - p) + scalars[off + 1] * p)


@dataclass(frozen=True)
class BornPr1(_Pr1):
    """Tomography Born rule: Pr(1) = clip(x₀e₀ + x₁e₁ + …, 0, 1), summed
    in that order; scalars tail = meas (n_cols,), columns x_d."""

    n_cols: int
    functor_id: ClassVar[int] = 8

    def __call__(self, scalars, off, *xs):
        acc = xs[0] * scalars[off]
        for d in range(1, self.n_cols):
            acc = acc + xs[d] * scalars[off + d]
        return torch.clamp(acc, 0.0, 1.0)


@dataclass(frozen=True)
class GivenPr1(_Pr1):
    """The column route's pr1: Pr(1) is the one column, evaluated by a pr1
    that has no CUDA functor; no scalars."""

    functor_id: ClassVar[int] = 9

    def __call__(self, scalars, off, p):
        return p


@dataclass(frozen=True)
class CudaPr1:
    """A model's own pr1 function. ``fn(scalars, off, *cols) -> Pr(1)`` is
    the pr1 in torch: the plain version, and the CPU route. ``source`` is
    its CUDA functor, ``struct UserPr1`` with the built-in functors'
    interface (``kMinCols``, ``kMaxColsUsed`` ≤ 64, a constructor ``(const
    float* s, const Consts& k, int n_cols)`` and ``template <class C>
    __device__ float operator()(const C& c, int64_t i) const``; see
    ``csrc/fused_update.cuh``), and ``consts`` the functor's compile-time
    constants, at most four floats read as ``k.v[j]`` (``fn`` keeps its own
    in its closure, as the JAX package's pr1 does). Equal values find the
    same library."""

    fn: Callable
    source: str
    consts: tuple = ()

    def __post_init__(self):
        consts = tuple(float(c) for c in self.consts)
        if len(consts) > _MAX_CONSTS:
            raise ValueError(f"a CUDA pr1 takes at most {_MAX_CONSTS} "
                             f"constants; got {len(consts)}")
        object.__setattr__(self, "consts", consts)

    def __call__(self, scalars, off, *cols):
        return self.fn(scalars, off, *cols)

    @functools.cached_property
    def library_key(self):
        """The key of the functor's library: a hash of ``source``."""
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]


def cuda_pr1(fn, source, consts=()):
    """A model's own pr1: ``fn`` in torch, ``source`` its CUDA functor,
    ``consts`` the functor's constants."""
    return CudaPr1(fn, source, tuple(consts))


precession_pr1 = PrecessionPr1()
rb_pr1 = RbPr1()
rb_interleaved_pr1 = RbInterleavedPr1()
inversion_pr1 = InversionPr1()
coin_pr1 = CoinPr1()
noisy_coin_pr1 = NoisyCoinPr1()
given_pr1 = GivenPr1()


def make_multicos_pr1(n_terms):
    return MultiCosPr1(int(n_terms))


def make_known_t2_pr1(t2):
    return KnownT2Pr1(float(t2))


def make_born_pr1(n_cols):
    return BornPr1(int(n_cols))


# -- outcome compositions ----------------------------------------------------

@dataclass(frozen=True)
class _OutcomeTile:
    pr1_fn: Any
    outcome_id: ClassVar[int]
    head: ClassVar[int]  # scalars before the pr1 function's own

    @property
    def kernel_tile(self):
        """(outcome_id, functor, consts) of the CUDA instantiation:
        ``functor`` is a built-in functor's id (int) or a user functor's
        library key (str). None when the pr1 function has neither (the
        column route)."""
        functor = getattr(self.pr1_fn, "functor_id", None)
        if functor is None:
            functor = getattr(self.pr1_fn, "library_key", None)
        if functor is None:
            return None
        return self.outcome_id, functor, tuple(self.pr1_fn.consts)


@dataclass(frozen=True)
class TwoOutcomeTile(_OutcomeTile):
    """scalars = [outcome, *pr1_scalars]; log(max(pr, 1e-35)) with
    pr = pr1 for outcome 1 and 1 − pr1 otherwise."""

    outcome_id: ClassVar[int] = 0
    head: ClassVar[int] = 1

    def __call__(self, scalars, *cols):
        pr1 = self.pr1_fn(scalars, 1, *cols)
        pr = torch.where(scalars[0] == 1.0, pr1, 1.0 - pr1)
        return torch.log(torch.clamp(pr, min=1e-35))


@dataclass(frozen=True)
class BinomialTile(_OutcomeTile):
    """scalars = [k, n_meas, log C(n, k), *pr1_scalars]:
    log C + k·log(max(p1, 1e-30)) + (n−k)·log(max(1−p1, 1e-30)) with p1
    clipped to [0, 1] (the clip reproduces xlogy's 0·log 0 = 0)."""

    outcome_id: ClassVar[int] = 1
    head: ClassVar[int] = 3

    def __call__(self, scalars, *cols):
        k, n, log_c = scalars[0], scalars[1], scalars[2]
        p1 = torch.clamp(self.pr1_fn(scalars, 3, *cols), 0.0, 1.0)
        return (log_c + k * torch.log(torch.clamp(p1, min=1e-30))
                + (n - k) * torch.log(torch.clamp(1.0 - p1, min=1e-30)))


def two_outcome_tile(pr1_fn):
    return TwoOutcomeTile(pr1_fn)


def binomial_tile(pr1_fn):
    return BinomialTile(pr1_fn)


# -- the update ----------------------------------------------------------------

def _lse_stats(lw):
    """(lse, lse2, ess) over the last axis of unnormalized log-weights."""
    m = torch.amax(lw, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(lw - m[..., None]), dim=-1))
    lw2 = 2.0 * lw
    m2 = torch.amax(lw2, dim=-1)
    lse2 = m2 + torch.log(torch.sum(torch.exp(lw2 - m2[..., None]), dim=-1))
    ess = torch.exp(-(lse2 - 2.0 * lse))
    return lse, lse2, ess


def fused_update_plain(tile_fn, scalars, log_w, param_cols):
    """Plain PyTorch version of the kernel: (lw, lse, lse2, ess) with lw
    unnormalized. Runs on any device."""
    log_l = tile_fn(scalars, *param_cols)
    lw = log_w + torch.clamp(log_l, min=_LOG_TINY)
    return (lw, *_lse_stats(lw))


def fused_update_plain_batched(tile_fn, scalars, log_w, param_cols):
    """Plain PyTorch version of the kernel on T banks: ``scalars`` (T, k),
    ``log_w`` and each column (T, N). Returns (lw (T, N) unnormalized, lse,
    lse2, ess, each (T,)). The tile runs unchanged: each scalar becomes a
    (T, 1) column that broadcasts over its trial's particles."""
    log_l = tile_fn(scalars.T[:, :, None], *param_cols)
    lw = log_w + torch.clamp(log_l, min=_LOG_TINY)
    return (lw, *_lse_stats(lw))


def _row_span(cols, min_stride=_MIN_SPAN_STRIDE):
    """``(s, offsets)`` when the kernel takes the row-span path for these
    f32 columns, else None. The path needs two columns or more, one element
    stride ``s`` shared by all (``min_stride`` ≤ s ≤ 20, or ≤ 64 for more
    than 16 columns; s ≥ the number of columns), one trial stride when the
    columns are (T, N), and every column's pointer at ``base +
    offsets[j]`` elements with ``0 ≤ offsets[j] < s``, ``base`` the lowest:
    views of one row-major (…, N, s) bank."""
    if len(cols) < 2:
        return None
    s = cols[0].stride(-1)
    top = (_MAX_SPAN_STRIDE if len(cols) > _NARROW_COLS
           else _NARROW_SPAN_STRIDE)
    if (not max(len(cols), min_stride) <= s <= top
            or any(c.stride(-1) != s or c.stride()[:-1] != cols[0].stride()[:-1]
                   for c in cols)):
        return None
    base = min(c.data_ptr() for c in cols)
    gaps = [c.data_ptr() - base for c in cols]
    if any(g % 4 or g // 4 >= s for g in gaps):
        return None
    return s, [g // 4 for g in gaps]


ONE_LAUNCH, TWO_PASS = "one_launch", "two_pass"  # the per-column path's forms


class GridPlan(NamedTuple):
    """How B1's per-column path runs a (T, N) update. ``n_blocks``: the
    virtual blocks a trial (the two-pass grid's blocks); ``blocks``: the
    physical blocks a trial; ``per_block``: the virtual blocks each walks;
    ``per_thread``: the rows a thread takes in each virtual block."""

    form: str
    n_blocks: int
    blocks: int
    per_block: int
    per_thread: int


def grid_plan(n_trials, n, capacity, form=None):
    """The form and grid of B1's per-column path for T = ``n_trials`` banks
    of ``n`` particles, on a card that holds ``capacity`` blocks of the
    one-launch kernel at once.

    The one-launch form takes one block a trial where a thread then holds
    at most 16 log-weights (N ≤ 4096: no barrier); else the fewest virtual
    blocks a physical block (and so the most blocks) such that a thread
    holds at most 16 log-weights and the T·blocks of the cooperative grid
    fill at most half the resident capacity: the grid barrier and the
    merge, which every block runs over all of its trial's partials, grow
    with the blocks, and on an H100 every resident block measured slower
    (``chip_profile.py --b1-forms``, PERF.md §6). Otherwise the two-pass
    form: N > 2^22, or too many trials for the card. ``form``
    forces ``ONE_LAUNCH`` (the grid of most virtual blocks a physical
    block when none fits, whose launch the card then refuses; N > 2^22
    raises ValueError) or ``TWO_PASS``."""
    n_blocks = max(1, min(_MAX_BLOCKS, -(-n // (_THREADS * _ITEMS_PER_THREAD))))
    per_thread = -(-n // (n_blocks * _THREADS))
    most = _HELD // per_thread
    if form not in (None, ONE_LAUNCH, TWO_PASS):
        raise ValueError(f"unknown B1 form {form!r}")
    if form != TWO_PASS:
        if n_blocks <= most:
            return GridPlan(ONE_LAUNCH, n_blocks, 1, n_blocks, per_thread)
        for per_block in range(1, most + 1):
            blocks = -(-n_blocks // per_block)
            if n_trials * blocks <= capacity // 2:
                return GridPlan(ONE_LAUNCH, n_blocks, blocks,
                                -(-n_blocks // blocks), per_thread)
        if form == ONE_LAUNCH:
            if most == 0:
                raise ValueError(
                    f"the one-launch form holds at most {_HELD} log-weights "
                    f"a thread; N = {n} needs {per_thread}")
            blocks = -(-n_blocks // most)
            return GridPlan(ONE_LAUNCH, n_blocks, blocks,
                            -(-n_blocks // blocks), per_thread)
    return GridPlan(TWO_PASS, n_blocks, n_blocks, 1, per_thread)


def _library(source):
    """The library that holds a functor: the built-in one, or the user
    functor's of this ``source``."""
    return (_build.library() if source is None
            else _build.user_library(source))[0]


@functools.lru_cache(maxsize=None)
def _capacity(outcome_id, functor_id, n_cols, batched, device_index,
              source=None):
    """Blocks of the one-launch instantiation for this tile resident at
    once on the device (occupancy × SMs), asked once per instantiation;
    ``source``: the user functor's (None: a built-in one)."""
    lib = _library(source)
    cap = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.qt_fused_update_capacity(outcome_id, functor_id, n_cols,
                                           2 if batched else 1,
                                           ctypes.byref(cap))
    _build.check(err, "qt_fused_update_capacity")
    return cap.value


def _kernel_of(tile_fn):
    """``(outcome_id, functor_id, consts, source)`` of the tile's CUDA
    instantiation: ``source`` is a user functor's (functor id 0 of its own
    library), None for a built-in one. Raises for a tile without one."""
    spec = getattr(tile_fn, "kernel_tile", None)
    if spec is None:
        raise NotImplementedError(
            f"no CUDA functor for likelihood tile {tile_fn!r}"
        )
    outcome_id, functor, consts = spec
    if isinstance(functor, str):
        return outcome_id, 0, consts, tile_fn.pr1_fn.source
    return outcome_id, functor, consts, None


def _fused_update_cuda(tile_fn, scalars, log_w, param_cols, row_span=None,
                       form=None, normalize=False):
    """Kernel B1 on T banks: ``scalars`` (T, k), ``log_w`` (T, N), each
    column (T, N) with one trial stride shared by all columns (views of
    one (T, N, D) bank). Returns (lw, lse, lse2, ess) as the plain version,
    lw normalised (lw − lse) when ``normalize``. T = 1 launches the
    single-bank instantiation. ``row_span``: None takes the path
    ``_row_span`` picks; True the row-span path at any stride ≥ 2 (raises
    when the layout has none), False the per-column path. ``form``: None
    takes the per-column path's form from ``grid_plan``; ``ONE_LAUNCH`` or
    ``TWO_PASS`` forces one (the row span has only the two-pass form).
    Both options are for comparing paths and forms. A tile whose pr1 has
    no CUDA functor raises here: the wrappers send it to the traced or the
    column route first (``_route``)."""
    outcome_id, functor_id, consts, source = _kernel_of(tile_fn)
    if len(param_cols) > MAX_COLS:
        raise ValueError(
            f"the fused update kernel takes at most {MAX_COLS} parameter "
            f"columns; got {len(param_cols)}"
        )
    device = log_w.device
    if log_w.dtype != torch.float32 or log_w.ndim != 2 or log_w.numel() == 0:
        raise ValueError("log_w must be a non-empty float32 (T, N) tensor")
    n_trials, n = log_w.shape
    if n_trials > MAX_TRIALS:
        raise ValueError(f"the fused update kernel takes at most {MAX_TRIALS} "
                         f"trials; got {n_trials}")
    log_w = log_w.contiguous()
    scalars = scalars.to(device=device, dtype=torch.float32).contiguous()
    if scalars.ndim != 2 or scalars.shape[0] != n_trials:
        raise ValueError("scalars must be (T, k) with one row per trial")
    cols = [c.to(torch.float32) for c in param_cols]
    if any(c.device != device or c.shape != (n_trials, n) for c in cols):
        raise ValueError("param_cols must be (T, N) tensors on log_w's device")
    trial_stride = cols[0].stride(0) if cols and n_trials > 1 else 0
    if any(c.stride(0) != trial_stride for c in cols[1:]) and n_trials > 1:
        raise ValueError("param_cols must share one trial stride (views of "
                         "one (T, N, D) bank)")
    span = None if row_span is False else _row_span(
        cols, 2 if row_span else _MIN_SPAN_STRIDE)
    if row_span and span is None:
        raise ValueError("the columns are not views of one row-major bank")
    if span and form == ONE_LAUNCH:
        raise ValueError("the row-span path has the two-pass form only")
    capacity = 0 if span or form == TWO_PASS else _capacity(
        outcome_id, functor_id, len(cols), n_trials > 1, device.index, source)
    plan = grid_plan(n_trials, n, capacity, TWO_PASS if span else form)
    one = plan.form == ONE_LAUNCH
    out = torch.empty_like(log_w)
    partials = torch.empty((n_trials, 3 * plan.n_blocks), dtype=torch.float32,
                           device=device)
    stats = torch.empty((n_trials, 4), dtype=torch.float32, device=device)
    col_ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    col_strides = (ctypes.c_int64 * len(cols))(*[c.stride(1) for c in cols])
    span_stride, offsets = span if span else (0, [])
    span_offsets = (ctypes.c_int32 * len(cols))(*offsets)
    span_base = min(c.data_ptr() for c in cols) if span else None
    const_buf = (ctypes.c_float * _MAX_CONSTS)(*consts)
    lib = _library(source)
    with torch.cuda.device(device):
        err = lib.qt_fused_update(
            outcome_id, functor_id, scalars.data_ptr(), scalars.shape[1],
            ctypes.cast(const_buf, ctypes.c_void_p), len(consts),
            log_w.data_ptr(), ctypes.cast(col_ptrs, ctypes.c_void_p),
            ctypes.cast(col_strides, ctypes.c_void_p), len(cols),
            span_base, ctypes.cast(span_offsets, ctypes.c_void_p), span_stride,
            trial_stride, out.data_ptr(), partials.data_ptr(),
            plan.n_blocks, stats.data_ptr(), n, n_trials,
            plan.blocks if one else 0, int(normalize),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_fused_update")
    if normalize and not one:
        out = out - stats[:, 0:1]
    return out, stats[:, 0], stats[:, 1], stats[:, 3]


def _route(tile_fn, scalars, param_cols, shape, batched):
    """What a CUDA launch runs for this tile: ``(tile, scalars, cols,
    route)``. A tile with a functor runs as it is, on the built-in library
    (route "builtin") or its user library ("user"). An outcome tile whose
    pr1 has none runs over the functor traced from its torch pr1
    (``pr1_trace.trace_pr1``, cached) from that source's library
    ("traced") or, where the tracer refuses the pr1, takes the column
    route ("column", ``_column``). Any other tile is returned as it is
    (route None), for ``_fused_update_cuda`` to refuse."""
    spec = getattr(tile_fn, "kernel_tile", None)
    if spec is not None:
        return (tile_fn, scalars, param_cols,
                "user" if isinstance(spec[1], str) else "builtin")
    if not isinstance(tile_fn, _OutcomeTile):
        return tile_fn, scalars, param_cols, None
    program = pr1_trace.trace_pr1(tile_fn.pr1_fn, len(param_cols))
    if isinstance(program, pr1_trace.Refusal):
        return _column(tile_fn, scalars, param_cols, shape, batched)
    if scalars.shape[-1] < tile_fn.head + program.n_scalars:
        raise ValueError(
            f"the pr1 reads {program.n_scalars} scalars after the outcome's "
            f"{tile_fn.head}; got {scalars.shape[-1]} scalars in all")
    return _traced_tile(type(tile_fn), program), scalars, param_cols, "traced"


@functools.lru_cache(maxsize=1024)
def _traced_tile(outcome, program):
    """The outcome composition ``outcome`` over the functor traced into
    ``program``, whose plain version runs the program with torch: made
    once, so that an update pays lookups."""
    return outcome(CudaPr1(functools.partial(pr1_trace.evaluate, program),
                           program.source))


def _column(tile_fn, scalars, param_cols, shape, batched):
    """The column route of an outcome tile: its pr1 evaluated by its torch
    function, in the wrapper's layout (``batched``: scalars (T, k) and
    (T, N) columns), broadcast to ``shape``, becomes the one column of the
    same outcome composition over ``GivenPr1``, with the composition's head
    of the scalars."""
    pr1 = tile_fn.pr1_fn(scalars.T[:, :, None] if batched else scalars,
                         tile_fn.head, *param_cols)
    return (type(tile_fn)(given_pr1), scalars[..., :tile_fn.head],
            (torch.broadcast_to(pr1, shape),), "column")


def _count(wrapper, route, n_cols):
    wrapper.launches += 1
    if route == "user":
        wrapper.user_launches += 1
    elif route == "traced":
        wrapper.traced_launches += 1
    elif route == "column":
        wrapper.column_launches += 1
    wide = n_cols > _NARROW_COLS
    wrapper.wide_launches += wide
    if torch.autograd._profiler_enabled():  # the counters count only then
        count(f"ops.{wrapper.__name__}.launches")
        if route != "builtin":
            count(f"ops.{wrapper.__name__}.{route}_launches")
        if wide:
            count(f"ops.{wrapper.__name__}.wide_launches")


def fused_bayes_update(tile_fn, scalars, log_w, param_cols,
                       return_stats=False):
    """One fused SMC update.

    ``scalars``: (k,) f32 on the bank's device (the outcome composition's
    head, then the pr1 function's expparams); ``log_w``: (N,) normalized
    log-weights; ``param_cols``: tuple of (N,) f32 parameter columns.

    Returns (log_w_normalized, log_norm, ess). ``return_stats=True``
    returns the raw (log_w_unnormalized, lse, lse2) instead, with
    lse = logsumexp(lw) and lse2 = logsumexp(2·lw).
    """
    with span("qinfer.ops.b1"):
        if log_w.is_cuda:
            tile, scal, cols, route = _route(tile_fn, scalars, param_cols,
                                             log_w.shape, batched=False)
            lw, lse, lse2, ess = _fused_update_cuda(
                tile, scal.reshape(1, -1), log_w[None],
                tuple(c[None] for c in cols), normalize=not return_stats)
            lw, lse, lse2, ess = lw[0], lse[0], lse2[0], ess[0]
            _count(fused_bayes_update, route, len(cols))
        else:
            lw, lse, lse2, ess = fused_update_plain(tile_fn, scalars, log_w,
                                                    param_cols)
            if not return_stats:
                lw = lw - lse
        if return_stats:
            return lw, lse, lse2
        return lw, lse, ess


fused_bayes_update.launches = 0
fused_bayes_update.user_launches = 0
fused_bayes_update.traced_launches = 0
fused_bayes_update.column_launches = 0
fused_bayes_update.wide_launches = 0
fused_bayes_update.unfused_wide = 0


def fused_bayes_update_batched(tile_fn, scalars, log_w, param_cols,
                               return_stats=False):
    """One fused SMC update of each of T independent banks, in one launch.

    The counterpart of the JAX package's ``custom_vmap`` rule of
    ``fused_bayes_update``. ``scalars``: (T, k), one row per trial;
    ``log_w``: (T, N); ``param_cols``: (T, N) columns, views of one
    (T, N, D) bank. Every bank size runs the kernel on CUDA. Returns
    (log_w_normalized (T, N), log_norm (T,), ess (T,)), or with
    ``return_stats`` the raw (lw, lse, lse2). Each trial's result is that
    of ``fused_bayes_update`` on it, bit for bit.
    """
    if log_w.shape[0] > MAX_TRIALS:
        raise ValueError(f"the fused update kernel takes at most {MAX_TRIALS} "
                         f"trials; got {log_w.shape[0]}")
    with span("qinfer.ops.b1"):
        if log_w.is_cuda:
            tile, scal, cols, route = _route(tile_fn, scalars, param_cols,
                                             log_w.shape, batched=True)
            lw, lse, lse2, ess = _fused_update_cuda(tile, scal, log_w, cols,
                                                    normalize=not return_stats)
            _count(fused_bayes_update_batched, route, len(cols))
        else:
            lw, lse, lse2, ess = fused_update_plain_batched(tile_fn, scalars,
                                                            log_w, param_cols)
            if not return_stats:
                lw = lw - lse[:, None]
        if return_stats:
            return lw, lse, lse2
        return lw, lse, ess


fused_bayes_update_batched.launches = 0
fused_bayes_update_batched.user_launches = 0
fused_bayes_update_batched.traced_launches = 0
fused_bayes_update_batched.column_launches = 0
fused_bayes_update_batched.wide_launches = 0
fused_bayes_update_batched.unfused_wide = 0
