"""A model's torch pr1 traced into B1's functor (CPU, small N).

``qinfer_tpu_torch.ops.pr1_trace`` traces a torch pr1 with ``make_fx`` into
a small program and writes it as a CUDA ``struct UserPr1``; the card runs
it as it runs a hand-written functor (``chip_smoke.py`` holds the two bit
for bit). Here, without a card:

- the program of ``chip_smoke.lost_visibility_pr1`` and of each built-in
  pr1's ``__call__``, run op by op with torch on the CPU
  (``pr1_trace.evaluate``), bit-equal to the eager function, in the
  single-bank layout and in the batched one (which trace to one source);
- the emitted source, compiled by the host's g++ (``-ffp-contract=off``,
  a stub header for the CUDA names) and run through ctypes: with torch's
  own cos bit-equal to the torch pr1, with glibc's cosf within 2 ulp of 1;
  a pr1 of every op of the table within 2 ulp of the sum's magnitude;
- the traced tile's plain route against the JAX package's Pallas kernel in
  interpret mode, at the tolerances of ``test_torch_user_tile.py``;
- the refusals, each with its reason, and the column route they take; the
  cache (one trace per distinct pr1, a fresh closure each call included);
  a generated source raising without ``nvcc``, with no fallback.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_tiles import (ESS_RTOL, LN_ATOL,
                                    assert_log_weights_close)
from test_torch_user_tile import CASES, IDS, _bank, _conditioning, _port_spec

from qinfer_tpu.ops import fused_update as jfu
from qinfer_tpu_torch import _build
from qinfer_tpu_torch.ops import fused_update as tfu
from qinfer_tpu_torch.ops import pr1_trace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 1031
_E16 = np.random.default_rng(16).uniform(-0.5, 0.5, 16).tolist()

# (name, pr1, n_cols, the pr1's scalars, each column's range)
PR1S = [
    ("lost_visibility", chip_smoke.lost_visibility_pr1, 2, [7.3],
     [(0, 1), (0.5, 1)]),
    ("precession", tfu.precession_pr1, 1, [17.3], [(0, 1)]),
    ("multicos", tfu.make_multicos_pr1(2), 2, [1.3, 0.4], [(0, 1), (0, 1)]),
    ("known_t2", tfu.make_known_t2_pr1(30.0), 1, [7.0], [(0, 1)]),
    ("rb", tfu.rb_pr1, 3, [32.0], [(0.8, 1), (0.2, 0.5), (0.3, 0.5)]),
    ("rb_interleaved", tfu.rb_interleaved_pr1, 4, [24.0, 0.0],
     [(0.8, 1), (0.8, 1), (0.2, 0.5), (0.3, 0.5)]),
    ("rb_interleaved_ref", tfu.rb_interleaved_pr1, 4, [24.0, 1.0],
     [(0.8, 1), (0.8, 1), (0.2, 0.5), (0.3, 0.5)]),
    ("inversion", tfu.inversion_pr1, 1, [0.3, 4.0], [(0, 1)]),
    ("coin", tfu.coin_pr1, 1, [], [(0, 1)]),
    ("noisy_coin", tfu.noisy_coin_pr1, 1, [0.9, 0.1], [(0, 1)]),
    ("born4", tfu.make_born_pr1(4), 4, [0.35, 0.35, 0.0, 0.0],
     [(-1, 1)] * 4),
    ("born16", tfu.make_born_pr1(16), 16, _E16, [(-0.5, 0.5)] * 16),
]
PR1_IDS = [c[0] for c in PR1S]
OFF = 1  # the two-outcome head


def _inputs(case, n=N, n_trials=None, seed=0):
    """(scalars (1 + k,) or (T, 1 + k), columns (n,) or (T, n)) from numpy."""
    _, _, _, tail, box = case
    rng = np.random.default_rng(seed)
    lead = () if n_trials is None else (n_trials,)
    cols = tuple(torch.from_numpy(rng.uniform(lo, hi, lead + (n,)).astype(
        np.float32)) for lo, hi in box)
    scal = np.array([1.0] + list(tail), np.float32)
    if n_trials is not None:
        scal = np.tile(scal, (n_trials, 1))
        scal[:, 1:] *= rng.uniform(0.5, 1.5, (n_trials, 1)).astype(np.float32)
        if case[0].startswith("rb_interleaved"):
            scal[:, 2] = tail[1]
    return torch.from_numpy(scal), cols


def _program(fn, n_cols):
    program = pr1_trace.trace_pr1(fn, n_cols)
    assert isinstance(program, pr1_trace.Pr1Program), program
    return program


@pytest.mark.parametrize("case", PR1S, ids=PR1_IDS)
def test_program_bit_equal_to_the_eager_pr1(case):
    """The traced program, run op by op with torch on the CPU, gives the
    eager pr1's bits, single bank and batched (scalars (k, T, 1), as the
    batched column route and ``_trial_pr1`` call a pr1)."""
    _, fn, n_cols, _, _ = case
    program = _program(fn, n_cols)
    scal, cols = _inputs(case)
    want = torch.broadcast_to(fn(scal, OFF, *cols), (N,))
    got = torch.broadcast_to(pr1_trace.evaluate(program, scal, OFF, *cols),
                             (N,))
    assert torch.equal(got, want)
    scal, cols = _inputs(case, n_trials=3, seed=1)
    layout = scal.T[:, :, None]
    want = torch.broadcast_to(fn(layout, OFF, *cols), (3, N))
    got = pr1_trace.evaluate(program, layout, OFF, *cols)
    assert torch.equal(torch.broadcast_to(got, (3, N)), want)


@pytest.mark.parametrize("case", PR1S, ids=PR1_IDS)
def test_single_bank_and_batched_layouts_give_one_source(case):
    _, fn, n_cols, _, _ = case
    batched = pr1_trace._trace(fn, n_cols, batched=True)
    assert isinstance(batched, pr1_trace.Pr1Program), batched
    assert batched.source == _program(fn, n_cols).source


def test_lost_visibility_source_reads_as_the_hand_written_functor():
    """The traced functor of the user model computes what
    ``chip_smoke.LOST_VISIBILITY_SOURCE`` computes, in its order: the
    scalar t read once a thread, ω·0.5·t, cos, 1 − c·c, v·p + (1 − v)·0.5,
    each product, sum and difference rounded alone."""
    source = _program(chip_smoke.lost_visibility_pr1, 2).source
    assert "kMinCols = 2, kMaxColsUsed = 2;" in source
    body = source[source.index("operator()"):]
    ops = [line.split("= ", 1)[1] for line in body.splitlines()
           if line.strip().startswith("const float")]
    assert [op.split("(", 1)[0] for op in ops] == [
        "c", "c", "mul", "mul", "cosf", "mul", "sub", "mul", "sub", "mul",
        "add"]
    assert "u4 = v4;" in source and "const float v4 = s[0];" in source


def test_division_by_a_host_scalar_is_torch_cudas():
    """A Python-scalar divisor becomes the product with its f32 reciprocal
    (torch's CUDA division by a CPU scalar); a device tensor divisor, as
    the known-T2 pr1's, a division."""
    src = _program(lambda s, off, p: p / 3.0, 1).source
    inv = np.float32(1.0) / np.float32(3.0)
    assert f"mul(v0, {float(inv):.9g}f)" in src and "__fdiv_rn" not in src
    src = _program(tfu.make_known_t2_pr1(30.0), 1).source
    assert "__fdiv_rn(v2, 30.0f)" in src


# -- the emitted source on the host compiler ------------------------------------

_STUB = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
struct Consts { float v[4]; };
static inline float mul(float a, float b) { return a * b; }
static inline float add(float a, float b) { return a + b; }
static inline float sub(float a, float b) { return a - b; }
static inline float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
static inline float __int_as_float(int x) {
  float f;
  memcpy(&f, &x, sizeof f);
  return f;
}
struct C {
  const float* const* p;
  float operator()(int j, int64_t i) const { return p[j][i]; }
};
typedef float (*qt_fn)(float);
static qt_fn qt_cos = cosf, qt_sin = sinf, qt_exp = expf, qt_log = logf;
extern "C" void set_math(qt_fn c, qt_fn s, qt_fn e, qt_fn l) {
  qt_cos = c; qt_sin = s; qt_exp = e; qt_log = l;
}
#define cosf(x) qt_cos(x)
#define sinf(x) qt_sin(x)
#define expf(x) qt_exp(x)
#define logf(x) qt_log(x)
"""
_RUN = r"""
extern "C" void pr1(const float* s, const float* const* cols, int n_cols,
                    float* out, int64_t n) {
  Consts k{};
  UserPr1 f(s, k, n_cols);
  C c{cols};
  for (int64_t i = 0; i < n; ++i) out[i] = f(c, i);
}
"""
_MATH = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


def _torch_math(fn):
    """``fn`` of torch on one f32, as a C function of a float."""
    return _MATH(lambda x: float(fn(torch.tensor(x, dtype=torch.float32))))


_TORCH_MATH = [_torch_math(f) for f in (torch.cos, torch.sin, torch.exp,
                                        torch.log)]


def _host_pr1(program, tmp_path, torch_math):
    """The emitted functor, built by g++ with the stub header: a function
    (scalars after off, columns) -> Pr(1). Its cosf, sinf, expf and logf
    are glibc's, or with ``torch_math`` torch's CPU functions (called back
    element by element)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "pr1.cpp"
    lib = tmp_path / "pr1.so"
    src.write_text(_STUB + program.source + _RUN)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    if torch_math:
        so.set_math.argtypes = [_MATH] * 4
        so.set_math(*_TORCH_MATH)
    fn = so.pr1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64]
    fn.restype = None

    def run(tail, cols):
        tail = np.ascontiguousarray(tail, np.float32)
        cols = [np.ascontiguousarray(c, np.float32) for c in cols]
        ptrs = (ctypes.c_void_p * len(cols))(*[c.ctypes.data for c in cols])
        out = np.empty(len(cols[0]), np.float32)
        fn(tail.ctypes.data, ctypes.cast(ptrs, ctypes.c_void_p), len(cols),
           out.ctypes.data, len(out))
        return out

    return run


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("torch_math", [True, False],
                         ids=["torch_math", "glibc_math"])
def test_lost_visibility_source_on_the_host_compiler(tmp_path, torch_math):
    """The emitted functor of the user model, built by g++: with torch's own
    cos it gives the torch pr1's bits; with glibc's cosf it is within 2 ulp
    of 1, the probability's scale (glibc's cosf and torch's CPU cos differ
    by an ulp on ~5 % of these inputs, and 1 − c·c turns an ulp of c near
    ±1 into ~2⁻²³ of absolute error)."""
    case = PR1S[0]
    run = _host_pr1(_program(case[1], 2), tmp_path, torch_math)
    scal, cols = _inputs(case, n=16384, seed=3)
    got = run(scal[OFF:].numpy(), [c.numpy() for c in cols])
    want = case[1](scal, OFF, *cols).numpy()
    assert np.all(np.isfinite(got))
    if torch_math:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 2 * np.spacing(np.float32(1.0))


def _every_op(s, off, p, q):
    """A pr1 that uses every op of the tracer's table once, each term of
    order one."""
    t = s[off]
    terms = [
        torch.cos(p * t), torch.sin(q) * 0.5, torch.exp(-p),
        torch.log(q + 1.0), torch.sqrt(p), torch.abs(p - q),
        1.0 / (q + 1.0), p / 3.0, p / torch.full((), 7.0, device=p.device),
        torch.maximum(p, q), torch.minimum(p, s[off + 1]),
        torch.clamp(p, 0.2, 0.8), torch.clamp(q, min=0.3),
        torch.clamp(q, max=0.6), torch.where(p > q, p, q),
        (p <= q).float(), torch.where(t == 2.0, p, 0.0), (p != q) * p,
        (p >= 0.5).float() - (q < 0.25).float() + (p == q).float(),
        p ** 2, p ** 3, (p + 1.0) ** -2, p ** 0.5, p ** -1 * 0.1, p ** 0,
        -(p * torch.tensor(2.0)), p.unsqueeze(0).squeeze(0) * t.view(1),
        torch.tensor(3.0).exp() * 0.1 + p,
    ]
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def test_every_op_on_the_host_compiler(tmp_path):
    """Each op of the table, emitted and built by g++ (with torch's own
    cos, sin, exp and log), agrees with the eager pr1: the sum of their
    terms within 2 ulp of its magnitude. (The terms differ where the
    functor follows torch's CUDA semantics and the eager CPU pr1 does
    not: p / 3.0 is the product with 1/3 on the card.)"""
    program = _program(_every_op, 2)
    rng = np.random.default_rng(4)
    p, q = (torch.from_numpy(rng.uniform(0.01, 1.0, 8192).astype(np.float32))
            for _ in range(2))
    scal = torch.tensor([1.0, 2.0, 0.4])
    want = _every_op(scal, OFF, p, q).numpy()
    assert torch.equal(pr1_trace.evaluate(program, scal, OFF, p, q),
                       torch.from_numpy(want))
    got = _host_pr1(program, tmp_path, True)(scal[OFF:].numpy(),
                                              [p.numpy(), q.numpy()])
    scale = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_array_less(np.abs(got - want), 2 * scale)


@pytest.mark.parametrize("value", [0.5, 1e-20, -0.0, 3.0, 1e30, 0.1,
                                   float("inf"), -float("inf"), 2.0 ** -140])
def test_literals_read_back_exactly(value):
    text = pr1_trace._literal(value)
    if "__int_as_float" in text:
        bits = int(text.split("(")[1].rstrip(")"), 16)
        got = np.array([bits], np.uint32).view(np.float32)[0]
    else:
        assert text.endswith("f") and ("." in text or "e" in text)
        got = np.float32(text[:-1])
    assert got == np.float32(value)
    assert np.signbit(got) == np.signbit(np.float32(value))


# -- the traced tile on the CPU against the JAX package --------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_traced_tile_matches_pallas_interpret(case):
    """``LostVisibilityModel(LOST_VISIBILITY_TORCH)`` and its binomial: the
    traced tile (as ``_route`` gives it) and a tile whose pr1 runs the
    traced program, each on the CPU's plain route, against the JAX
    package's Pallas kernel in interpret mode."""
    name, model_u, model_j, outcome, ep = case
    under = getattr(model_u, "underlying_model", None)
    model_t = (type(model_u)(type(under)(chip_smoke.LOST_VISIBILITY_TORCH))
               if under is not None
               else type(model_u)(chip_smoke.LOST_VISIBILITY_TORCH))
    locs, lw = _bank(4096, 4096 + len(name))
    tile_t, scal_t, cols_t = _port_spec(model_t, outcome, locs, ep)
    assert tile_t.kernel_tile is None
    lw_t = torch.from_numpy(lw)
    traced, _, _, route = tfu._route(tile_t, scal_t, cols_t, lw_t.shape,
                                     batched=False)
    assert route == "traced" and isinstance(traced.kernel_tile[1], str)
    program = _program(chip_smoke.LOST_VISIBILITY_TORCH, 2)
    run_ir = type(tile_t)(lambda s, off, *c: pr1_trace.evaluate(
        program, s, off, *c))
    under_j = model_j.underlying_model or model_j
    pr1, _, cols_j = under_j._fused_pr1_parts(jnp.asarray(locs), ep)
    tile_j = (jfu.binomial_tile(pr1) if name == "binomial"
              else jfu.two_outcome_tile(pr1))
    j_lw, j_ln, j_ess = jfu.fused_bayes_update(
        tile_j, jnp.asarray(scal_t.numpy()), jnp.asarray(lw), cols_j,
        tile=1024, interpret=True)
    counts = (tfu.fused_bayes_update.launches,
              tfu.fused_bayes_update.traced_launches)
    results = [tfu.fused_bayes_update(t, scal_t, lw_t, cols_t)
               for t in (traced, run_ir, tile_t)]
    assert (tfu.fused_bayes_update.launches,
            tfu.fused_bayes_update.traced_launches) == counts  # CPU: plain
    for t_lw, t_ln, t_ess in results:
        assert_log_weights_close(t_lw.numpy(), j_lw,
                                 _conditioning(outcome, ep, locs))
        np.testing.assert_allclose(float(t_ln), float(j_ln), atol=LN_ATOL)
        np.testing.assert_allclose(float(t_ess), float(j_ess), rtol=ESS_RTOL)
    for a, b in zip(results[0], results[1]):
        assert torch.equal(a, b)


# -- refusals, the cache, the build ----------------------------------------------

_HALF = torch.tensor([0.5])


# (name, pr1 of one column, the reason's pattern)
REFUSALS = [
    ("branch_on_a_value", lambda s, off, p: p if s[off] > 0 else 1.0 - p,
     "does not trace: GuardOnDataDependentSymNode"),
    ("reduction", lambda s, off, p: p - p.mean(),
     "aten.mean.default reads across particles"),
    ("op_outside_the_table", lambda s, off, p: torch.addcmul(p, p, p),
     "aten.addcmul.default is not in the tracer's op table"),
    ("in_place", lambda s, off, p: (p * s[off]).cos_(), "an in-place op"),
    ("item", lambda s, off, p: p * s[off].item(), "on the host"),
    ("read_from_the_end", lambda s, off, p: p * s[-1], "from their end"),
    ("read_before_off", lambda s, off, p: p * s[off - 1], "before off"),
    ("captured_1d_tensor", lambda s, off, p: p * _HALF,
     "FakeTensorDeviceMismatchError"),
    ("pow_by_2_5", lambda s, off, p: p ** 2.5, r"pow by 2\.5"),
    ("integer_arithmetic", lambda s, off, p: p * s[off].long(),
     "torch.int64 arithmetic"),
    ("alpha", lambda s, off, p: torch.add(p, p, alpha=2), "with alpha"),
    ("whole_scalars", lambda s, off, p: p * s.sum(), "scalars tensor whole"),
    ("bool_pr1", lambda s, off, p: p > 0.5, "returns a bool"),
    ("bool_arithmetic", lambda s, off, p: ((p > 0.5) + (p < 0.2)).float(),
     "bool arithmetic"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refused_pr1_takes_the_column_route(case):
    _, fn, pattern = case
    refusal = pr1_trace.trace_pr1(fn, 1)
    assert isinstance(refusal, pr1_trace.Refusal)
    assert re.search(pattern, refusal.reason), refusal.reason
    x = torch.rand(64)
    tile = tfu.two_outcome_tile(fn)
    assert tfu._route(tile, torch.tensor([1.0, 2.0]), (x,), x.shape,
                      False)[3] == "column"


def test_the_chip_smoke_column_twin_is_refused():
    refusal = pr1_trace.trace_pr1(chip_smoke.LOST_VISIBILITY_COLUMN, 2)
    assert "in-place" in refusal.reason


def test_one_trace_per_distinct_pr1():
    """A pr1 traced once per (pr1, n_cols); a closure made afresh each call
    (as a ``_fused_pr1_parts`` may make it) by its code and its closure's
    values."""
    def make(scale):
        def pr1(s, off, p):
            return p * scale + s[off]
        return pr1

    before = pr1_trace.trace_pr1.traces
    first = pr1_trace.trace_pr1(make(0.25), 1)
    for _ in range(5):
        assert pr1_trace.trace_pr1(make(0.25), 1) is first
    assert pr1_trace.trace_pr1.traces == before + 1
    other = pr1_trace.trace_pr1(make(0.5), 1)
    assert other is not first and "0.5f" in other.source
    assert pr1_trace.trace_pr1(make(0.25), 2) is not first
    assert pr1_trace.trace_pr1.traces == before + 3
    x, scal = torch.rand(16), torch.tensor([1.0, 2.0])
    tile = tfu.two_outcome_tile(make(0.25))
    for _ in range(3):
        tfu._route(tfu.two_outcome_tile(make(0.25)), scal, (x,), x.shape,
                   False)
        tfu._route(tile, scal, (x,), x.shape, False)
    assert pr1_trace.trace_pr1.traces == before + 3


def test_short_scalars_raise():
    """A traced pr1 that reads more scalars than the tile has raises before
    any launch."""
    tile = tfu.two_outcome_tile(lambda s, off, p: p * s[off + 2])
    x = torch.rand(16)
    with pytest.raises(ValueError, match="reads 3 scalars"):
        tfu._route(tile, torch.tensor([1.0, 2.0]), (x,), x.shape, False)


def test_generated_source_raises_without_nvcc(tmp_path, monkeypatch):
    """Without nvcc the traced functor's build raises, and so does a launch
    of the traced tile: nothing takes the column route or the plain
    version."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    _build.user_library.cache_clear()
    tfu._capacity.cache_clear()
    try:
        locs, lw = _bank(256, 1)
        tile, scal, cols = _port_spec(
            chip_smoke.LostVisibilityModel(chip_smoke.LOST_VISIBILITY_TORCH),
            1, locs, {"t": np.array([2.0], np.float32)})
        lw = torch.from_numpy(lw)
        traced, _, _, route = tfu._route(tile, scal, cols, lw.shape, False)
        assert route == "traced"
        counts = (tfu.fused_bayes_update.column_launches,
                  tfu.fused_bayes_update.traced_launches,
                  tfu.fused_bayes_update.launches)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfu._fused_update_cuda(traced, scal[None], lw[None],
                                   tuple(c[None] for c in cols))
        source = _program(chip_smoke.LOST_VISIBILITY_TORCH, 2).source
        unit = tmp_path / "user" / _build.user_digest(source) / "user_pr1.cu"
        assert unit.read_text() == _build.user_translation_unit(source)
        assert (tfu.fused_bayes_update.column_launches,
                tfu.fused_bayes_update.traced_launches,
                tfu.fused_bayes_update.launches) == counts
    finally:
        _build.user_library.cache_clear()
        tfu._capacity.cache_clear()
