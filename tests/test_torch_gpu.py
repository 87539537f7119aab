"""Kernel-against-plain tests on the card, at the shapes of chip_smoke.py.

Marked ``gpu``; each test skips (through the ``cuda`` fixture) when torch
sees no CUDA device. This file imports neither jax nor qinfer_tpu, so on
a GPU machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import state_from_numpy, state_to_numpy
from qinfer_tpu_torch import profiling
from qinfer_tpu_torch import tomography as tomo
from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import psd_valid as pv
from qinfer_tpu_torch.ops import resample_expand as b2
from qinfer_tpu_torch.resamplers import (
    systematic_segment_starts,
    systematic_segment_starts_batched,
)
from qinfer_tpu_torch.utils import sqrtm_psd

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

N = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("outcome,t", [(0, 2.0), (0, 17.3), (1, 2.0),
                                       (1, 17.3)])
def test_fused_update_kernel_matches_plain(cuda, n, outcome, t):
    g = torch.Generator(device=cuda).manual_seed(n)
    omega = torch.rand(n, generator=g, device=cuda)
    lw = torch.log(torch.rand(n, generator=g, device=cuda))
    lw = lw - torch.logsumexp(lw, 0)
    scal = torch.tensor([float(outcome), t], device=cuda)
    tile = b1.two_outcome_tile(b1.precession_pr1)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, (omega,))
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, (omega,))
    torch.cuda.synchronize()
    # The JAX package's kernel-test tolerances.
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


def _log_weights(kind, n, rng):
    if kind == "random":
        w = rng.random(n) ** 3
    elif kind == "degenerate":
        w = np.zeros(n)
        w[17] = 1.0
    else:
        w = np.full(n, 1e-9)
        w[n // 2 + 1] = 1.0
    with np.errstate(divide="ignore"):
        return np.log(w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.ZOO, ids=lambda c: c[0])
def test_zoo_tile_kernel_matches_plain(cuda, case, n):
    tile, scal, lw, cols = chip_smoke.zoo_inputs(case, n, n, cuda)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


def test_wide_or_unknown_tile_raises_on_cuda(cuda):
    """More columns than the kernel takes (MAX_COLS = 64 for any tile)
    raises on CUDA instead of running the plain version, while MultiCos at
    9 terms runs on its wide instantiation; so does a pr1 with no functor
    handed to the kernel itself, which the wrapper traces (or, where the
    tracer refuses it, sends to the column route), counted. The SMC step
    sends a tile over MAX_COLS to the unfused update first
    (``test_multicos_past_8_terms_takes_b1_and_past_64_the_unfused_step``)."""
    model = qt.MultiCosModel(n_terms=9)
    locs = torch.rand((256, 9), device=cuda)
    lw = torch.full((256,), -float(np.log(256.0)), device=cuda)
    ep = {"ts": torch.rand((1, 9), device=cuda)}
    tile, scal, cols_9 = model.fused_spec(1, locs, ep)
    lw_k, _, _ = model.fused_update(1, lw, locs, ep)
    lw_p, lse_p, _, _ = b1.fused_update_plain(tile, scal, lw, cols_9)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-6, rtol=0)
    cols = b1.MAX_COLS + 1
    born = b1.two_outcome_tile(b1.make_born_pr1(cols))
    wide = torch.rand((256, cols), device=cuda)
    with pytest.raises(ValueError, match=f"at most {b1.MAX_COLS}"):
        b1.fused_bayes_update(born, torch.rand(cols + 1, device=cuda), lw,
                              tuple(wide[:, d] for d in range(cols)))
    tile = b1.two_outcome_tile(lambda scalars, off, x: x)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        b1._fused_update_cuda(tile, torch.ones((1, 1), device=cuda), lw[None],
                              (locs[None, :, 0],))
    refused = b1.two_outcome_tile(lambda scalars, off, x: x - x.mean())
    counts = (b1.fused_bayes_update.launches,
              b1.fused_bayes_update.traced_launches,
              b1.fused_bayes_update.column_launches)
    b1.fused_bayes_update(tile, torch.ones(1, device=cuda), lw, (locs[:, 0],))
    b1.fused_bayes_update(refused, torch.ones(1, device=cuda), lw,
                          (locs[:, 0],))
    assert (b1.fused_bayes_update.launches,
            b1.fused_bayes_update.traced_launches,
            b1.fused_bayes_update.column_launches) == (
                counts[0] + 2, counts[1] + 1, counts[2] + 1)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.TOMO, ids=lambda c: c[0])
def test_born_tile_kernel_matches_plain(cuda, case, n):
    tile, scal, lw, cols = chip_smoke.tomo_inputs(case, n, n, cuda)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


# B1's outputs on fixed inputs (a digest of their bytes), recorded on an
# H100 with torch 2.11 from the kernels before the 64-column Born functor
# was added: its wider bounds must leave the other instantiations' bits
# as they were.
B1_DIGESTS = {
    "born16_1000": "1452b3a2ac8e5101", "born16_1048576": "d3154a89e72db722",
    "born16_1048579": "96c84c520dac03a9",
    "born16_stats_1000": "5df86a41152a816d",
    "born16_stats_1048576": "60426ea91ee6749a",
    "born16_stats_1048579": "2c54d4e44dc8de12",
    "born4_1000": "bf10992299207c15", "born4_1048576": "573017f19364b1f1",
    "born4_1048579": "46a38d2d8fea6c52",
    "precession_1000_17.3": "b9ff2e6211ae3a04",
    "precession_1000_2.0": "5a3412804a5f67a0",
    "precession_1048576_17.3": "648c593080b29467",
    "precession_1048576_2.0": "70898a1d1cdbf385",
    "precession_1048579_17.3": "f55ae433bc124f2a",
    "precession_1048579_2.0": "be8698c3e8672faf",
    "precession_batched_256x2048": "fd02626b17e24728",
    "precession_batched_4x262144": "ce4272b00fe4681f",
    "precession_stats_1000_17.3": "f6a8a5d4d1530dca",
    "precession_stats_1000_2.0": "f60e4a6273a35389",
    "precession_stats_1048576_17.3": "16a1c29a013f2a79",
    "precession_stats_1048576_2.0": "27aebce013a13fe0",
    "precession_stats_1048579_17.3": "ae00f1d1e77141d4",
    "precession_stats_1048579_2.0": "f45d5468536eb45c",
}


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def test_b1_outputs_bit_equal_to_the_recorded_ones(cuda):
    """The precession tile (one bank, with and without ``return_stats``,
    and two trial grids), born4 and born16 (the row span) give the bits
    that they gave before the 64-column functor."""
    out = {}
    g = torch.Generator(device=cuda).manual_seed(7)
    tile = b1.two_outcome_tile(b1.precession_pr1)
    for n in (1000, N + 3, N):
        omega = torch.rand(n, generator=g, device=cuda)
        lw = torch.log_softmax(torch.randn(n, generator=g, device=cuda), 0)
        for t in (2.0, 17.3):
            scal = torch.tensor([1.0, t], device=cuda)
            out[f"precession_{n}_{t}"] = _digest(
                b1.fused_bayes_update(tile, scal, lw, (omega,)))
            out[f"precession_stats_{n}_{t}"] = _digest(b1.fused_bayes_update(
                tile, scal, lw, (omega,), return_stats=True))
    for n in (1000, N + 3, N):
        args = chip_smoke.tomo_inputs(chip_smoke.TOMO[2], n, 3, cuda)
        out[f"born16_{n}"] = _digest(b1.fused_bayes_update(*args))
        out[f"born16_stats_{n}"] = _digest(b1.fused_bayes_update(
            *args, return_stats=True))
        args = chip_smoke.tomo_inputs(chip_smoke.TOMO[0], n, 4, cuda)
        out[f"born4_{n}"] = _digest(b1.fused_bayes_update(*args))
    for n_trials, n in ((256, 2048), (4, 1 << 18)):
        omega = torch.rand((n_trials, n), generator=g, device=cuda)
        lw = torch.log_softmax(torch.randn((n_trials, n), generator=g,
                                           device=cuda), 1)
        scal = torch.stack([torch.ones(n_trials, device=cuda),
                            torch.rand(n_trials, generator=g,
                                       device=cuda) * 20], 1)
        out[f"precession_batched_{n_trials}x{n}"] = _digest(
            b1.fused_bayes_update_batched(tile, scal, lw, (omega,)))
    assert out == B1_DIGESTS


def _born64_inputs(device, n=N, seed=1):
    """(tile, scalars, log_w, cols) of a binomial Born update of a
    three-qubit Ginibre bank (n, 64), row-major, its 64 columns views."""
    basis = tomo.pauli_basis(3)
    model = qt.BinomialModel(tomo.TomographyModel(basis))
    g = torch.Generator(device=device).manual_seed(seed)
    locs = tomo.GinibreDistribution(basis).sample(g, n)
    lw = torch.log_softmax(torch.randn(n, generator=g, device=device), 0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, 2)) + 1j * rng.standard_normal((3, 2))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    p = [np.outer(x, x.conj()) for x in v]
    meas = torch.as_tensor(basis.state_to_modelparams(
        np.kron(np.kron(p[0], p[1]), p[2])), dtype=torch.float32,
        device=device)
    ep = {"meas": meas[None], "n_meas": torch.tensor([50], device=device)}
    tile, scal, cols = model.fused_spec(torch.tensor(9, device=device), locs,
                                        ep)
    return tile, scal, lw, cols


# The kernel's log-sum-exp merges per-block partials in a fixed tree; the
# plain version reduces with torch's sums: the two agree to a few ulps of
# the largest log-likelihood (measured on an H100: see PERF.md §6).
B1_LSE_ULPS = 64


@pytest.mark.parametrize("n", [1000, N + 3, N])
def test_born64_row_span_matches_plain(cuda, n):
    """B1 at 64 columns on a row-major three-qubit bank: one launch of the
    row span (two passes), its raw log-weights bit-equal to the plain
    version's (the Born sum and the binomial log-likelihood rounded as
    torch rounds them), lse within B1_LSE_ULPS ulps of the largest
    log-likelihood; the per-column path gives the row span's bits; the wrapper
    counts a wide launch."""
    tile, scal, lw, cols = _born64_inputs(cuda, n)
    assert len(cols) == 64 and b1._row_span(cols) == (64, list(range(64)))
    batched = (scal[None], lw[None], tuple(c[None] for c in cols))
    span = b1._fused_update_cuda(tile, *batched)
    per_col = b1._fused_update_cuda(tile, *batched, row_span=False,
                                    form=b1.TWO_PASS)
    one = b1._fused_update_cuda(tile, *batched, row_span=False)
    lw_p, lse_p, lse2_p, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    wide = b1.fused_bayes_update.wide_launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    torch.cuda.synchronize()
    assert b1.fused_bayes_update.wide_launches == wide + 1
    for a, b, c in zip(span, per_col, one):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert torch.equal(span[0][0], lw_p)
    log_l = (lw_p - lw).abs().max()
    ulp = float(torch.finfo(torch.float32).eps) * float(log_l)
    assert abs(float(span[1][0]) - float(lse_p)) <= B1_LSE_ULPS * ulp
    assert abs(float(span[2][0]) - float(lse2_p)) <= 2 * B1_LSE_ULPS * ulp
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


@pytest.mark.parametrize("n_terms", [10, b1.MAX_COLS + 1])
def test_multicos_past_8_terms_takes_b1_and_past_64_the_unfused_step(
        cuda, n_terms):
    """MultiCos at 10 terms (past its 8-term instantiation) updates on
    CUDA through B1's wide instantiation, one launch; at MAX_COLS + 1 terms
    the step sends it to the unfused update before any launch, counted as
    ``unfused_wide``. Both agree with the CPU route (its unfused update)
    within B1_TOL's atol on log-weights, 1e-4 (the JAX package's kernel
    test): the card's cos and the CPU's round apart by up to 3e-5 here."""
    model = qt.MultiCosModel(n_terms=n_terms)
    g = torch.Generator().manual_seed(3)
    locs = torch.rand((4096, n_terms), generator=g)
    ts = torch.rand((1, n_terms), generator=g) / n_terms
    config = qt.smc.SMCConfig(resample_thresh=0.0,
                              zero_weight_policy="reset")
    out = {}
    counts = (b1.fused_bayes_update.launches, b1.fused_bayes_update.unfused_wide)
    for dev in ("cpu", cuda):
        state = qt.smc.init_smc_state(torch.Generator(device=dev), model,
                                      4096, qt.UniformDistribution(
                                          [[0, 1]] * n_terms))
        state = dataclasses.replace(
            state, particle_locations=locs.to(dev),
            particle_log_weights=torch.full((4096,), -math.log(4096.0),
                                            device=dev))
        out[str(dev)], _ = qt.smc.smc_update_step(
            model, qt.LiuWestResampler(), config, state,
            torch.tensor(1, device=dev), {"ts": ts.to(dev)})
    wide = n_terms > b1.MAX_COLS
    assert (b1.fused_bayes_update.launches,
            b1.fused_bayes_update.unfused_wide) == (counts[0] + (not wide),
                                                    counts[1] + wide)
    torch.testing.assert_close(out["cuda:0"].particle_log_weights.cpu(),
                               out["cpu"].particle_log_weights,
                               atol=chip_smoke.B1_TOL["lw_atol"], rtol=0)


def _reference_3q():
    path = ROOT / "benchmark" / "reference" / "tomography_3q.py"
    spec = importlib.util.spec_from_file_location("_ref_3q", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_three_qubit_step_resamples_to_states(cuda):
    """One three-qubit ``smc_update_step`` on a CUDA bank that resamples:
    B1's wide launch, B2 at D = 64, d = 8 postselection on the kernels of
    ``csrc/psd_valid.cu`` (one test of the drawn bank, one launch a redraw
    round, every round the kernel's); every particle after it a state by
    the f64 reference's ``eigvalsh`` (with the f32 slack of the
    benchmark's guarantee)."""
    ref = _reference_3q()
    n = 1 << 16
    basis = tomo.pauli_basis(3)
    model = qt.BinomialModel(tomo.TomographyModel(basis, psd_tol=1e-5))
    state = qt.smc.init_smc_state(torch.Generator(device=cuda).manual_seed(2),
                                  model, n, tomo.GinibreDistribution(basis))
    tile, scal, lw, cols = _born64_inputs(cuda, 8)
    config = qt.smc.SMCConfig(resample_thresh=1.0,
                              zero_weight_policy="reset")
    counts = (b1.fused_bayes_update.wide_launches,
              b2.expand_sorted_segments.launches)
    launches = pv.psd_valid.launches, pv.psd_redraw.launches
    rounds = qt.LiuWestResampler.redraw_rounds
    kernel_rounds = qt.LiuWestResampler.kernel_rounds
    after, _ = qt.smc.smc_update_step(
        model, qt.LiuWestResampler(a=0.98, maxiter=16), config, state,
        torch.tensor(30, device=cuda),
        {"meas": scal[3:][None], "n_meas": torch.tensor([50], device=cuda)})
    assert bool(after.just_resampled) and int(after.n_resamples) == 1
    assert (b1.fused_bayes_update.wide_launches,
            b2.expand_sorted_segments.launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    rounds = qt.LiuWestResampler.redraw_rounds - rounds
    assert rounds > 0
    assert qt.LiuWestResampler.kernel_rounds - kernel_rounds == rounds
    assert (pv.psd_valid.launches - launches[0],
            pv.psd_redraw.launches - launches[1]) == (1, rounds)
    assert after.particle_locations.shape == (n, 64)
    assert bool(model.are_models_valid(after.particle_locations).all())
    tol = math.sqrt(8.0) * 1e-4 + 1e-6
    assert ref.invalid(after.particle_locations, 1e-5 + 1e-6, tol) == 0


@pytest.mark.parametrize("copy", ["all", "every_other"])
def test_strided_and_contiguous_columns_agree(cuda, copy):
    """The kernel reads each column in place with its own stride; copies
    of the same columns (stride 1), all of them or every other one, give
    the same bits."""
    tile, scal, lw, cols = chip_smoke.tomo_inputs(chip_smoke.TOMO[2], 4099,
                                                  5, cuda)
    assert cols[0].stride(0) == 16
    step = 1 if copy == "all" else 2
    mixed = tuple(c.contiguous() if j % step == 0 else c
                  for j, c in enumerate(cols))
    strided = b1.fused_bayes_update(tile, scal, lw, cols)
    copied = b1.fused_bayes_update(tile, scal, lw, mixed)
    torch.cuda.synchronize()
    for a, b in zip(strided, copied):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.SPAN_CASES,
                         ids=lambda c: f"s{c[0]}_k{c[1]}_{c[2]}")
def test_row_span_path_bit_equal_to_per_column(cuda, case, n):
    """On the same views of one (N, s) bank, the row-span path's
    log-weights, lse, lse2 and ESS equal the per-column path's bit for
    bit, for one bank and for T = 3 (each trial also bit-equal to a
    single-bank launch); the wrapper's own path stays within the kernel
    tolerances of the plain version."""
    s, k, view = case
    tile, scal, lw, cols = chip_smoke.span_inputs(s, k, view, n, 11, cuda)
    assert (b1._row_span(cols) is not None) == (s >= 8)
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    span, per_col = chip_smoke.both_paths(tile, scal[None], lw[None],
                                          tuple(c[None] for c in cols))
    torch.cuda.synchronize()
    for a, b in zip(span, per_col):
        assert torch.equal(a, b)
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)
    tile, scal, lw, cols = chip_smoke.span_inputs(s, k, view, n, 12, cuda,
                                                  n_trials=3)
    span, per_col = chip_smoke.both_paths(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for a, b in zip(span, per_col):
        assert torch.equal(a, b)
    for i in range(3):
        single = b1._fused_update_cuda(tile, scal[i:i + 1], lw[i:i + 1],
                                       tuple(c[i:i + 1] for c in cols),
                                       row_span=True)
        assert torch.equal(single[0][0], span[0][i])
        assert torch.equal(single[1][0], span[1][i])


@pytest.mark.parametrize("d", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("affine", [False, True])
def test_expand_forms_bit_equal(cuda, d, kind, affine):
    """B2 with n_out < n_in: the wrapper's form (the bank form up to D = 8,
    the span form at D ≥ 9) and every form forced (the merge path and the
    bank form up to D = 8) are bit-equal to the plain version."""
    n_in, n_out = 16385, 10007
    rng = np.random.default_rng(d)
    vals = torch.as_tensor(rng.standard_normal((n_in, d)),
                           dtype=torch.float32, device=cuda)
    log_w = torch.as_tensor(_log_weights(kind, n_in, rng), device=cuda)
    starts = systematic_segment_starts(log_w, n_in, u0=0.37)
    aff = b2._affine(0.98, 0.02 * vals[0], d, cuda) if affine else None
    out = b2.expand_sorted_segments(starts, vals, n_out=n_out,
                                    scale=0.98 if affine else None,
                                    shift=0.02 * vals[0] if affine else None)
    forms = [b2._expand_cuda_batched(starts[None], vals[None], n_out,
                                     None if aff is None else aff[None],
                                     form=form)[0]
             for form in (b2.ROWS, b2.SPAN) + ((b2.MERGE, b2.BANK) if d <= 8 else ())]
    ref = b2.expand_plain(starts, vals, n_out, aff)
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in [out] + forms)


@pytest.mark.parametrize("n,n_out", [(2000, 2000), (16385, 16385),
                                     (1 << 15, 1 << 15), (1 << 15, 9001)])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("rows", [None, 100, 256, 512, 513, 1000, 2048])
def test_bank_form_tiles_bit_equal(cuda, n, n_out, kind, rows):
    """B2's bank form on three trials back to back (unaligned trial
    offsets at odd n), in tiles of ``rows`` rows (searched up to 512 rows,
    scanned above; the wrapper's tiling for None), the starts staged in
    one phase or, at the cap, two: bit-equal to the plain version."""
    rng = np.random.default_rng(n + n_out)
    log_w = torch.as_tensor(np.stack([_log_weights(kind, n, rng)
                                      for _ in range(3)]), device=cuda)
    starts = qt.resamplers.systematic_segment_starts_batched(
        log_w, n, u0=torch.full((3,), 0.37, device=cuda))
    if n_out < n:
        starts = torch.clamp(starts - n // 5, min=0).to(torch.int32)
    vals = torch.as_tensor(rng.standard_normal((3, n, 3)),
                           dtype=torch.float32, device=cuda)
    aff = b2._affine_batched(0.98, 0.02 * vals[:, 0], 3, 3, cuda)
    out = b2._expand_cuda_batched(
        starts, vals, n_out, aff, form=b2.BANK,
        tiles=None if rows is None else -(-n_out // rows))
    ref = b2.expand_plain_batched(starts, vals, n_out, aff)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _one_and_two_passes_equal(tile, scal, lw, cols):
    if not chip_smoke.one_launch_resident(tile, lw, cols)[0]:
        chip_smoke.refused_one_launch(tile, scal, lw, cols)
        return
    one, two = chip_smoke.both_forms(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("case", ("precession",) + chip_smoke.ZOO
                         + chip_smoke.TOMO,
                         ids=lambda c: c if isinstance(c, str) else c[0])
def test_one_launch_bit_equal_to_two_passes(cuda, case, n):
    """B1's per-column path: the one-launch form's lw − lse, lse, lse2, ESS
    and raw lw equal the two-pass form's bit for bit. Where the forced
    one-launch grid is not resident (the 64-column tile at 2^20 + 3), the
    card refuses it and the wrapper plans two passes."""
    if case == "precession":
        omega, lw = chip_smoke._b1_inputs(n, n, cuda)
        tile = b1.two_outcome_tile(b1.precession_pr1)
        scal, cols = torch.tensor([1.0, 17.3], device=cuda), (omega,)
    elif case in chip_smoke.ZOO:
        tile, scal, lw, cols = chip_smoke.zoo_inputs(case, n, n, cuda)
    else:
        tile, scal, lw, cols = chip_smoke.tomo_inputs(case, n, n, cuda)
    _one_and_two_passes_equal(tile, scal[None], lw[None],
                              tuple(c[None] for c in cols))


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["precession", "multicos", "born4"])
def test_batched_one_launch_bit_equal_to_two_passes(cuda, name, shape):
    _one_and_two_passes_equal(*chip_smoke.batched_b1_inputs(name, *shape, 5,
                                                            cuda))


def test_too_large_cooperative_grid_raises(cuda):
    """512 trials of 2^14 particles need 4 blocks a trial at the least in
    one launch: more than the card holds at once, so the plan takes two
    passes and a forced one-launch form is refused."""
    tile, scal, lw, cols = chip_smoke.batched_b1_inputs("precession", 512,
                                                        1 << 14, 1, cuda)
    cap = b1._capacity(0, 0, 1, True, cuda.index)
    assert b1.grid_plan(512, 1 << 14, cap).form == b1.TWO_PASS
    with pytest.raises(RuntimeError, match="cudaError"):
        b1._fused_update_cuda(tile, scal, lw, cols, form=b1.ONE_LAUNCH)
    b1.fused_bayes_update_batched(tile, scal, lw, cols)  # the card recovers
    torch.cuda.synchronize()


@pytest.mark.parametrize("model_case", [0, 2], ids=["qubit", "binomial_2q"])
def test_design_on_a_cuda_bank(cuda, model_case):
    """bayes_risk and expected_information_gain on a CUDA bank: the
    outcomes and Q follow the bank to the card, and the result agrees with
    the same state on the CPU."""
    _, model, prior, _, _ = chip_smoke.TOMO[model_case]
    u = qt.SMCUpdater(model, 1 << 14, prior, zero_weight_policy="reset",
                      device=cuda)
    if isinstance(model, qt.BinomialModel):
        rng = np.random.default_rng(0)
        cand = {"meas": np.stack([chip_smoke.product_projector_2q(rng)
                                  for _ in range(3)]),
                "n_meas": np.full(3, 50, np.int32)}
    else:
        cand = {"meas": chip_smoke.EFFECTS_1Q}
    host = qt.SMCUpdater(model, 1 << 14, prior, zero_weight_policy="reset",
                         device="cpu")
    host.state = state_from_numpy(state_to_numpy(u.state))
    for name in ("bayes_risk", "expected_information_gain"):
        on_card = getattr(u, name)(cand)
        assert on_card.device.type == "cuda" and on_card.shape == (3,)
        torch.testing.assert_close(on_card.cpu(), getattr(host, name)(cand),
                                   rtol=1e-4, atol=1e-6)


def test_tomography_paths_run_through_both_kernels(cuda):
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.config5_window(chip_smoke.config5_updater(1 << 16, 1,
                                                             cuda), 0)
    ok, err, spread = chip_smoke.config5_gate(w)
    assert ok, (err, spread)
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_STEPS_1Q
    assert (b2.expand_sorted_segments.launches - l2
            >= w["updater"].resample_count > 0)
    l1 = b1.fused_bayes_update.launches
    w = chip_smoke.tomography_2q_window(
        chip_smoke.tomography_2q_updater(1 << 16, 1, cuda))
    ok, overlap = chip_smoke.tomography_2q_gate(w)
    assert ok, overlap
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_SETTINGS_2Q


@pytest.mark.parametrize("make", chip_smoke.CONFIGS,
                         ids=lambda m: m.__name__)
def test_config_path_runs_through_both_kernels(cuda, make):
    cfg = make()
    u = qt.SMCUpdater(cfg.model, 1 << 16, qt.UniformDistribution(cfg.prior),
                      zero_weight_policy="reset", device=cuda)
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    u.batch_update(cfg.outcomes, cfg.expparams)
    ok, est, sd = cfg.gate(u.est_mean().cpu().numpy(),
                           u.est_covariance_mtx().cpu().numpy())
    assert ok, (est, sd)
    assert b1.fused_bayes_update.launches - l1 == len(cfg.outcomes)
    assert b2.expand_sorted_segments.launches - l2 >= u.resample_count > 0


@pytest.mark.parametrize("n", [257, 16385, N])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16, 64])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("affine", [False, True])
def test_expand_kernel_equals_plain_bitwise(cuda, n, d, kind, affine):
    rng = np.random.default_rng(n + d)
    vals = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                           device=cuda)
    log_w = torch.as_tensor(_log_weights(kind, n, rng), device=cuda)
    starts = systematic_segment_starts(log_w, n, u0=0.37)
    scale, shift = (0.98, 0.02 * vals[0]) if affine else (None, None)
    launches = b2.expand_sorted_segments.launches
    out = b2.expand_sorted_segments(starts, vals, scale=scale, shift=shift)
    assert b2.expand_sorted_segments.launches == launches + 1
    ref = b2.expand_plain(starts, vals, n, b2._affine(scale, shift, d, cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_failed_launch_raises(cuda):
    """A launch the C entry point refuses (no columns) raises."""
    starts = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        b2._expand_cuda(starts, torch.empty((8, 0), device=cuda), 8, None)


def test_main_path_runs_through_both_kernels(cuda):
    rng = np.random.default_rng(0)
    ts = np.minimum((9 / 8) ** np.arange(100), 1e4).astype(np.float32)
    outcomes = (rng.random(100)
                >= np.cos(0.5 * 0.70710678 * ts) ** 2).astype(np.int32)
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), N,
                      qt.UniformDistribution([0, 1]),
                      zero_weight_policy="reset", device=cuda)
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    u.batch_update(outcomes, {"t": ts})
    assert abs(float(u.est_mean()[0]) - 0.70710678) < 0.05
    assert b1.fused_bayes_update.launches - l1 == 100
    assert b2.expand_sorted_segments.launches - l2 >= u.resample_count > 0


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["precession", "multicos", "born4"])
def test_batched_fused_update_kernel(cuda, name, shape):
    """One launch for T banks: within the kernel tolerances of its plain
    version, and each trial bit-equal to a single-bank launch."""
    tile, scal, lw, cols = chip_smoke.batched_b1_inputs(name, *shape, 3,
                                                        cuda)
    launches = b1.fused_bayes_update_batched.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    assert b1.fused_bayes_update_batched.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain_batched(tile, scal, lw,
                                                          cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p[:, None], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(ln_k, lse_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(ess_k, ess_p, rtol=1e-3, atol=0)
    for i in range(shape[0]):
        lw_1, ln_1, _ = b1.fused_bayes_update(tile, scal[i], lw[i],
                                              tuple(c[i] for c in cols))
        assert torch.equal(lw_1, lw_k[i]) and torch.equal(ln_1, ln_k[i])


@pytest.mark.parametrize("shape", chip_smoke.B2_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_batched_expand_kernel_bit_equal(cuda, shape):
    n_trials, n, d = shape
    starts, vals, mu = chip_smoke.batched_b2_inputs(n_trials, n, d, 1, cuda)
    launches = b2.expand_sorted_segments_batched.launches
    out = b2.expand_sorted_segments_batched(starts, vals, scale=0.98,
                                            shift=0.02 * mu)
    assert b2.expand_sorted_segments_batched.launches == launches + 1
    ref = b2.expand_plain_batched(
        starts, vals, n, b2._affine_batched(0.98, 0.02 * mu, n_trials, d,
                                            cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for i in range(n_trials):
        assert torch.equal(out[i], b2.expand_sorted_segments(
            starts[i], vals[i], scale=0.98, shift=0.02 * mu[i]))


def test_ensemble_runs_through_the_batched_kernels(cuda):
    """Banks of 2048 resample through the fused Liu–West launch alone, at
    least once a step that resampled (and once in the warm-up)."""
    b1_single = b1.fused_bayes_update.launches
    l1 = b1.fused_bayes_update_batched.launches
    l2 = b2.expand_sorted_segments_batched.launches
    fused = b2.liu_west_expand_batched.launches
    unfused = qt.LiuWestResampler.unfused_batched
    seconds, perf, steps_resampled = chip_smoke.ensemble_run(32, 2048, 30, 7,
                                                             cuda)
    assert float(np.median(perf["loss"][:, -1])) < 1e-3
    assert b1.fused_bayes_update_batched.launches - l1 == 30 + 2  # warm-up
    assert b1.fused_bayes_update.launches == b1_single
    assert b2.expand_sorted_segments_batched.launches == l2
    assert qt.LiuWestResampler.unfused_batched == unfused
    assert (b2.liu_west_expand_batched.launches - fused
            > steps_resampled > 0)
    assert seconds > 0


# The fused Liu–West launch against the eager chain it replaces.
LIU_WEST_SHAPES = [(t, n, d) for d in (1, 2, 4) for n in (1, 37, 512, 2048)
                   for t in (1, 74, 256)]
LIU_WEST_KINDS = ("random", "single_heavy", "uniform", "some_inf", "reset",
                  "zero_cov")
LIU_WEST_A = 0.98
LIU_WEST_H = math.sqrt(1.0 - LIU_WEST_A ** 2)


def _liu_west_bank(kind, n_trials, n, d, device):
    """(log_w (T, N), locs (T, N, D), u0 (T,)) with weights of ``kind``:
    random; each bank's weight on one particle over an e^−30 floor; equal
    unnormalised; random with about 30 % at −inf (one particle finite);
    the zero-weight reset's −log N; random again (``zero_cov``)."""
    rng = np.random.default_rng(n_trials * 7919 + n * 31 + d)
    lw = 3.0 * rng.standard_normal((n_trials, n))
    if kind == "single_heavy":
        lw = np.full((n_trials, n), -30.0)
        lw[np.arange(n_trials), rng.integers(n, size=n_trials)] = 0.0
    elif kind == "uniform":
        lw = np.full((n_trials, n), 2.5)
    elif kind == "some_inf":
        lw[rng.random((n_trials, n)) < 0.3] = -np.inf
        lw[np.arange(n_trials), rng.integers(n, size=n_trials)] = 0.0
    elif kind == "reset":
        lw = np.full((n_trials, n), -math.log(n))
    locs = rng.random((n_trials, n, d))
    u0 = rng.random(n_trials)
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (lw, locs, u0))


@pytest.mark.parametrize("shape", LIU_WEST_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
@pytest.mark.parametrize("kind", LIU_WEST_KINDS)
def test_fused_liu_west_matches_the_eager_chain(cuda, shape, kind):
    """One launch gives the eager chain's μ, Σ and (D = 1) h·Σ^{1/2} within
    f32 rounding of the sums' order, and its rows: the rows are compared
    bit for bit with the plain expand of the chain's starts at the
    kernel's own μ, so a row differs only where its source does, which a
    quantised weight on a rounding edge can move (at most 1 row in 10^4,
    rounded up)."""
    n_trials, n, d = shape
    lw, locs, u0 = _liu_west_bank(kind, n_trials, n, d, cuda)
    zero_cov = 1e-3 if kind == "zero_cov" else 0.0
    launches = b2.liu_west_expand_batched.launches
    out, mu, cov, root = b2.liu_west_expand_batched(
        lw, locs, u0, LIU_WEST_A, LIU_WEST_H, zero_cov)
    assert b2.liu_west_expand_batched.launches == launches + 1
    plain = qt.LiuWestResampler(a=LIU_WEST_A, h=LIU_WEST_H,
                                zero_cov_comp=zero_cov,
                                use_expand_kernel=False)
    _, mu_p, cov_p, _ = plain._unfused_centers(lw, locs, u0, None)
    torch.testing.assert_close(mu, mu_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(cov, cov_p, rtol=1e-4, atol=1e-6)
    if d == 1:
        root_p = sqrtm_psd((LIU_WEST_H * LIU_WEST_H) * cov_p)
        torch.testing.assert_close(root, root_p, rtol=1e-4, atol=1e-5)
    else:
        assert root is None
    starts = systematic_segment_starts_batched(lw, n, u0=u0)
    ref = b2.expand_plain_batched(starts, locs, n, b2._affine_batched(
        LIU_WEST_A, (1.0 - LIU_WEST_A) * mu, n_trials, d, cuda))
    torch.cuda.synchronize()
    differ = int((out != ref).any(dim=2).sum())
    assert differ <= math.ceil(n_trials * n * 1e-4), differ


@pytest.mark.parametrize("n,d,use,fused", [
    (2048, 1, None, True), (37, 4, True, True), (2048, 8, None, True),
    (2049, 1, None, False), (512, 9, None, False), (2048, 1, False, False)])
def test_batched_resample_takes_its_route_on_the_card(cuda, n, d, use, fused):
    """``LiuWestResampler.batched`` on the card: one fused launch for banks
    of ≤ 2048 rows and ≤ 8 columns, else the eager chain (counted by the
    resampler), with batched B2 unless the expand kernel is off."""
    lw, locs, u0 = _liu_west_bank("random", 3, n, d, cuda)
    counts0 = (b2.liu_west_expand_batched.launches,
               qt.LiuWestResampler.unfused_batched,
               b2.expand_sorted_segments_batched.launches)
    g = torch.Generator(device=cuda).manual_seed(3)
    out = qt.LiuWestResampler(postselect=False, use_expand_kernel=use).batched(
        g, None, locs, lw, u0=u0)
    counts = (b2.liu_west_expand_batched.launches,
              qt.LiuWestResampler.unfused_batched,
              b2.expand_sorted_segments_batched.launches)
    assert [c - c0 for c, c0 in zip(counts, counts0)] == [
        int(fused), int(not fused), int(not fused and use is not False)]
    assert out.shape == locs.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("path", chip_smoke.PGH_PATHS, ids=lambda p: p[0])
def test_pgh_paths_run_through_both_kernels(cuda, path):
    _, model, truth, slack = path
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.pgh_window(model, truth, 1, cuda, n=1 << 16)
    assert w["finite"] and abs(w["est"] - truth) < 6 * w["sd"] + slack
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_PGH_STEPS
    assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


def test_entry_points_default_to_the_card(cuda):
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 1024,
                      qt.UniformDistribution([0, 1]))
    assert u.particle_locations.device.type == "cuda"
    perf = qt.perf_test_multiple(2, qt.SimplePrecessionModel(), 256,
                                 qt.UniformDistribution([0, 1]), 3, qt.PGH)
    assert perf.shape == (2, 3)


def test_accelerated_precession_update_bit_equal_to_simple(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    locs = torch.rand((N, 1), generator=g, device=cuda)
    lw = torch.log(torch.rand(N, generator=g, device=cuda))
    lw = lw - torch.logsumexp(lw, 0)
    ep = {"t": torch.tensor([17.3], device=cuda)}
    launches = b1.fused_bayes_update.launches
    out_a = qt.AcceleratedPrecessionModel().fused_update(1, lw, locs, ep)
    out_s = qt.SimplePrecessionModel().fused_update(1, lw, locs, ep)
    assert b1.fused_bayes_update.launches == launches + 2
    torch.cuda.synchronize()
    assert all(torch.equal(a, s) for a, s in zip(out_a, out_s))


def test_credible_set_and_histogram_against_the_host(cuda):
    """The device's credible cut against an f64 NumPy recomputation (±1),
    and the device histogram against np.histogram on the same weights."""
    cfg = chip_smoke.config4_multicos2()
    _, _, _, _, u = chip_smoke._config_window(cfg, 4, cuda, n=1 << 16)
    region = u.est_credible_region(0.95)
    w = u.particle_weights.cpu().numpy()
    assert region.device.type == "cuda"
    assert abs(region.shape[0] - chip_smoke.host_credible_size(w)) <= 1
    xs, hist = u.posterior_marginal(1)
    x = u.particle_locations[:, 1].cpu().numpy()
    ref, edges = np.histogram(x, bins=100, range=(float(x.min()),
                                                  float(x.max())),
                              weights=w, density=True)
    assert hist.device.type == "cuda"
    np.testing.assert_allclose(hist.cpu().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * ref.max())
    np.testing.assert_array_equal(xs.cpu().numpy(),
                                  0.5 * (edges[1:] + edges[:-1]))
    s = chip_smoke.posterior_summaries(u, cfg.truth, cuda)
    assert chip_smoke.summaries_gate(s), s


def test_engine_api_paths_run_through_both_kernels(cuda):
    for window, gate, n_b1 in (
            (chip_smoke.bcrb_window, chip_smoke.bcrb_gate,
             lambda w: chip_smoke.N_EXP),
            (chip_smoke.track_rsd_window, chip_smoke.track_rsd_gate,
             lambda w: chip_smoke.N_EXP),
            (chip_smoke.mixed_ale_window, chip_smoke.mixed_ale_gate,
             lambda w: chip_smoke.N_EXP - w["approx_updates"])):
        l1 = b1.fused_bayes_update.launches
        l2 = b2.expand_sorted_segments.launches
        w = window(1 << 16, 1, cuda)
        assert gate(w), {k: v for k, v in w.items() if k != "updater"}
        assert b1.fused_bayes_update.launches - l1 == n_b1(w)
        assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


def test_new_updaters_default_to_the_card(cuda):
    prior = qt.UniformDistribution([0, 1])
    u = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 1024, prior)
    assert u.particle_locations.device.type == "cuda"
    assert u.current_bim.device.type == "cuda"
    m = qt.MixedApproximateSMCUpdater(
        qt.SimplePrecessionModel(),
        qt.ALEApproximateModel(simulator=qt.SimplePrecessionModel()), 1024,
        prior)
    assert m.particle_locations.device.type == "cuda"
    m.update(1, {"t": np.array([1.0], np.float32)})
    assert m.model is m.approximate_model


# -- the rest of the model zoo (vector outcomes, random walks, Poisson) ----------

def _zoo_likelihood_cases():
    rng = np.random.default_rng(0)
    die3 = rng.dirichlet(np.ones(3), 4096).astype(np.float32)
    walk = np.stack([rng.random(4096), rng.uniform(0, 0.05, 4096)],
                    1).astype(np.float32)
    beta = rng.uniform(0.0, 5.0, 4096)
    pois = np.stack([rng.random(4096), beta + rng.uniform(0, 20, 4096), beta],
                    1).astype(np.float32)
    omega = rng.random((4096, 1)).astype(np.float32)
    return [
        (qt.NDieModel(n=3), die3, {"exp_num": np.zeros(2, np.int32)},
         torch.arange(3)),
        (qt.MultinomialModel(qt.NDieModel(n=3)), die3,
         {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([20, 20])},
         qt.MultinomialDomain(20, 3).values),
        (qt.RandomWalkModel(qt.BinomialModel(qt.SimplePrecessionModel()),
                            qt.NormalDistribution(0.0, 1e-4)), omega,
         {"t": np.array([np.pi / 2], np.float32), "n_meas": np.array([40])},
         torch.arange(41)),
        (qt.GaussianRandomWalkModel(qt.SimplePrecessionModel()), walk,
         {"t": np.array([1.0, 9.0], np.float32)}, torch.arange(2)),
        (qt.MLEModel(qt.CoinModel(), likelihood_power=4.0), omega,
         {"dummy": np.zeros(1, np.float32)}, torch.arange(2)),
        (qt.ReferencedPoissonModel(qt.SimplePrecessionModel(), max_rate=25.0),
         pois, {"t": np.array([1.0, 2.0, 3.0], np.float32),
                "mode": np.array([0, 1, 2])}, torch.arange(60)),
    ]


@pytest.mark.parametrize("i", range(6), ids=["ndie", "multinomial", "walk",
                                             "gaussian_walk", "mle",
                                             "poisson"])
def test_zoo_model_likelihood_on_cuda_matches_cpu(cuda, i):
    model, params, ep, outcomes = _zoo_likelihood_cases()[i]
    ep_dev = {k: torch.as_tensor(v, device=cuda) for k, v in ep.items()}
    got = model.log_likelihood(outcomes.to(cuda),
                               torch.from_numpy(params).to(cuda), ep_dev)
    ref = model.log_likelihood(outcomes, torch.from_numpy(params), ep)
    assert got.device.type == "cuda"
    # Likelihoods, as test_torch_models.py holds the two packages: cos and
    # lgamma round differently on the card, and 1 − cos² near ω = 0
    # cancels in f32, so Pr(1) there is good to ~2⁻²³ absolute and a
    # 40-shot likelihood to ~40·2⁻²³ ≈ 5e-6.
    got, ref = got.cpu().numpy(), ref.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(np.exp(got), np.exp(ref), rtol=1e-3,
                               atol=1e-5)
    sims = model.simulate_experiment(
        torch.Generator(device=cuda).manual_seed(0),
        torch.from_numpy(params[:64]).to(cuda), ep_dev, repeat=3)
    assert sims.device.type == "cuda" and sims.dtype == torch.int32


def _assert_moments(x, mean, var):
    x = x.double()
    n = x.shape[0]
    assert torch.all((x.mean(0) - mean).abs() < 5 * (var / n).sqrt() + 1e-9)
    assert torch.all((x.var(0) / var - 1.0).abs() < 0.05)


def test_cuda_generator_draws_by_moments(cuda):
    """sample_multinomial (torch.binomial), torch.poisson and
    torch._standard_gamma on a CUDA generator: on the card, reproducible
    from the seed, with the right first two moments at 2^20 draws."""
    n = 1 << 20

    def gen(seed=0):
        return torch.Generator(device=cuda).manual_seed(seed)

    p = torch.tensor([0.6, 0.3, 0.1], device=cuda)
    counts = qt.utils.sample_multinomial(gen(), torch.tensor(20.0), p, (n,))
    assert counts.device.type == "cuda"
    assert bool((counts.sum(1) == 20).all())
    torch.testing.assert_close(
        counts, qt.utils.sample_multinomial(gen(), torch.tensor(20.0), p,
                                            (n,)), rtol=0, atol=0)
    _assert_moments(counts, 20 * p.double(), 20 * p.double() * (1 - p.double()))
    lam = torch.full((n, 2), 7.5, device=cuda)
    lam[:, 1] = 120.0
    draws = qt.utils.poisson(lam, gen(1))
    assert draws.device.type == "cuda"
    _assert_moments(draws, lam[0].double(), lam[0].double())
    alpha = torch.full((n, 2), 0.7, device=cuda)
    alpha[:, 1] = 5.0
    g = qt.utils.standard_gamma(alpha, gen(2))
    assert g.device.type == "cuda" and bool((g > 0).all())
    _assert_moments(g, alpha[0].double(), alpha[0].double())
    beta = qt.BetaDistribution(2.0, 5.0).sample(gen(3), n)
    _assert_moments(beta, torch.tensor(2 / 7, dtype=torch.float64,
                                       device=cuda),
                    torch.tensor(10 / 392, dtype=torch.float64, device=cuda))


def test_samplers_in_a_row_are_independent(cuda):
    """Two binomial (and two Poisson) calls in a row on one CUDA generator
    draw independently: |r| < 5/√n at 2^20."""
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(4)
    count = torch.full((n,), 20.0, device=cuda)
    for draw in (lambda: qt.utils.binomial(count, count * 0.02, g),
                 lambda: qt.utils.poisson(count * 0.4, g)):
        a, b = draw(), draw()
        r = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        assert abs(r) < 5 / np.sqrt(n), r


def test_every_distribution_samples_on_cuda(cuda):
    dists = [
        qt.UniformDistribution([[0, 1], [2, 3]]), qt.MVUniformDistribution(4),
        qt.DiscreteUniformDistribution(3), qt.ConstantDistribution([1.0]),
        qt.NormalDistribution(0.0, 2.0),
        qt.NormalDistribution(0.0, 1.0, trunc=(2.0, 6.0)),
        qt.MultivariateNormalDistribution([0, 1], [[1, 0.5], [0.5, 2]]),
        qt.SlantedNormalDistribution([[0, 1]]), qt.LogNormalDistribution(),
        qt.BetaDistribution(2.0, 5.0), qt.BetaBinomialDistribution(12, 2, 3),
        qt.GammaDistribution(3.0, 2.0),
        qt.ProductDistribution(qt.NormalDistribution(),
                               qt.UniformDistribution([0, 1])),
        qt.MixtureDistribution([1, 3], [qt.NormalDistribution(-1, 0.5),
                                        qt.NormalDistribution(2, 0.1)]),
        qt.ConstrainedSumDistribution(qt.UniformDistribution([[0, 1]] * 3)),
        qt.PostselectedDistribution(qt.NormalDistribution(0.5, 0.25),
                                    qt.SimplePrecessionModel()),
        qt.InterpolatedUnivariateDistribution(lambda x: np.exp(-x * x / 2),
                                              2.0, 500),
    ]
    g = torch.Generator(device=cuda).manual_seed(0)
    for d in dists:
        s = d.sample(g, 1 << 16)
        assert s.device.type == "cuda" and s.shape == (1 << 16, d.n_rvs)
        assert bool(torch.isfinite(s).all()), type(d).__name__


@pytest.mark.parametrize("path", chip_smoke.ZOO_PATHS, ids=lambda p: p[0])
def test_model_zoo_paths_run_unfused_through_b2(cuda, path):
    """Each model-zoo path at N = 2^16: its gate, no B1 launch (no tile),
    B2 at least once per resample."""
    name, make, window, gate = path
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = window(make(1 << 16, 1, cuda))
    ok, values = gate(w)
    assert ok, (name, values)
    assert w["updater"].particle_locations.device.type == "cuda"
    assert b1.fused_bayes_update.launches == l1
    assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


@pytest.mark.parametrize("k_shards", chip_smoke.SHARD_KS)
@pytest.mark.parametrize("d", chip_smoke.SHARD_DS)
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
def test_expand_kernel_on_shard_windows(cuda, k_shards, d, kind):
    """B2 on each rank's window of a 2^20 bank over K ranks (n_in = 2^20,
    n_out = 2^20 / K, shifted starts with a run of leading zeros) bit-equal
    to its plain version; the windows together equal one bank's expand."""
    rng = np.random.default_rng(k_shards + d)
    log_w = torch.as_tensor(_log_weights(kind, N, rng), device=cuda)
    vals = torch.as_tensor(rng.standard_normal((N, d)), dtype=torch.float32,
                           device=cuda)
    n_local = N // k_shards
    starts, windows = chip_smoke.shard_windows(log_w, k_shards, 0.61)
    torch.testing.assert_close(starts, systematic_segment_starts(
        log_w, N, u0=0.61), rtol=0, atol=0)
    launches = b2.expand_sorted_segments.launches
    outs = [b2.expand_sorted_segments(w, vals, n_out=n_local, scale=0.98,
                                      shift=0.5) for w in windows]
    assert b2.expand_sorted_segments.launches == launches + k_shards
    aff = b2._affine(0.98, 0.5, d, cuda)
    for w, out in zip(windows, outs):
        assert torch.equal(out, b2.expand_plain(w, vals, n_local, aff))
    assert torch.equal(torch.cat(outs), b2.systematic_expand(
        log_w, vals, scale=0.98, shift=0.5, u0=0.61))


@pytest.mark.parametrize("name", ["precession", "born4"])
def test_fused_update_stats_merge_over_shards(cuda, name):
    """B1's raw statistics on 4 slices, merged as the sharded step merges
    them, against the one-bank launch (B1_TOL), the raw lw bit-equal."""
    if name == "precession":
        omega, lw = chip_smoke._b1_inputs(N, 3, cuda)
        tile, scal, cols = (b1.two_outcome_tile(b1.precession_pr1),
                            torch.tensor([0.0, 9.1], device=cuda), (omega,))
    else:
        tile, scal, lw, cols = chip_smoke.tomo_inputs(chip_smoke.TOMO[0], N,
                                                      3, cuda)
    lw_1, ln_1, ess_1 = b1.fused_bayes_update(tile, scal, lw, cols)
    blocks = [slice(k * N // 4, (k + 1) * N // 4) for k in range(4)]
    parts = [b1.fused_bayes_update(tile, scal, lw[b], tuple(c[b] for c in cols),
                                   return_stats=True) for b in blocks]
    log_norm = chip_smoke.merge_lse(torch.stack([p[1] for p in parts]))
    lse2 = chip_smoke.merge_lse(torch.stack([p[2] for p in parts]))
    raw = torch.cat([p[0] for p in parts])
    assert torch.equal(raw, b1.fused_bayes_update(tile, scal, lw, cols,
                                                  return_stats=True)[0])
    torch.testing.assert_close(raw - log_norm, lw_1, atol=1e-4, rtol=0)
    assert abs(float(log_norm) - float(ln_1)) <= 1e-4
    assert float(torch.exp(2 * log_norm - lse2)) == pytest.approx(
        float(ess_1), rel=1e-3)


@pytest.fixture
def nccl_world_one(cuda):
    """An NCCL process group of one rank (file store), destroyed after the
    test; yields the particle mesh."""
    with chip_smoke.nccl_world_one(cuda) as mesh:
        yield mesh


@pytest.mark.parametrize("migration", ["all_gather", "ring"])
def test_sharded_step_on_nccl_world_one(cuda, nccl_world_one, migration):
    """The flagship record through the sharded step at 2^20 on one rank:
    the gate, B1 once per update (raw statistics), B2 at least once per
    resample on the all-gather and never on the ring."""
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.sharded_flagship_window(nccl_world_one, migration, 5, 0,
                                           cuda)
    assert w["ok"], w["gate"]
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_EXP
    b2_launches = b2.expand_sorted_segments.launches - l2
    if migration == "ring":
        assert b2_launches == 0 and w["resamples"] > 0
    else:
        assert b2_launches >= w["resamples"] > 0


@pytest.mark.parametrize("kind", ["pgh", "eig"])
def test_sharded_episodes_on_nccl_world_one(cuda, nccl_world_one, kind):
    w = chip_smoke.sharded_episode_window(nccl_world_one, kind, 1, cuda)
    assert w["ok"], w["gate"]


def test_checkpoint_resumes_a_cuda_updater_bit_for_bit(cuda, tmp_path):
    from qinfer_tpu_torch import checkpointing

    ts, outcomes = chip_smoke.experiment_record(chip_smoke.N_EXP, 0)

    def updater(seed):
        return qt.SMCUpdater(qt.SimplePrecessionModel(), 1 << 16,
                             qt.UniformDistribution([0, 1]),
                             zero_weight_policy="reset", seed=seed,
                             device=cuda)

    a = updater(1)
    a.batch_update(outcomes[:50], {"t": ts[:50]})
    checkpointing.save_npz(tmp_path / "ckpt.npz", a)
    at_save = a.resample_count
    b = checkpointing.load_npz(tmp_path / "ckpt.npz", updater(2))
    for u in (a, b):
        u.batch_update(outcomes[50:], {"t": ts[50:]})
    assert a.resample_count > at_save
    for name in ("particle_locations", "particle_log_weights", "n_resamples"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))


# -- B1 on a model's own pr1 (chip_smoke's user model) ----------------------------

@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("binomial", [False, True], ids=["two_outcome",
                                                         "binomial"])
def test_user_functor_matches_plain(cuda, binomial, n):
    """The user library's tile against its plain version, and the column
    route (the twin that the tracer refuses) against the user tile, within
    B1_TOL."""
    tile, scal, lw, cols = chip_smoke.user_inputs(binomial, n, n, cuda)
    counts = (b1.fused_bayes_update.user_launches,
              b1.fused_bayes_update.column_launches)
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    twin = type(tile)(chip_smoke.LOST_VISIBILITY_COLUMN)
    lw_c, ln_c, ess_c = b1.fused_bayes_update(twin, scal, lw, cols)
    assert (b1.fused_bayes_update.user_launches,
            b1.fused_bayes_update.column_launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for lw_x, ln_x, ess_x, lw_y, ln_y, ess_y in (
            (lw_k, ln_k, ess_k, lw_p - lse_p, lse_p, ess_p),
            (lw_c, ln_c, ess_c, lw_k, ln_k, ess_k)):
        torch.testing.assert_close(lw_x, lw_y, atol=1e-4, rtol=0)
        assert abs(float(ln_x) - float(ln_y)) <= 1e-4
        assert float(ess_x) == pytest.approx(float(ess_y), rel=1e-3)


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_user_functor_trial_grid_bit_equal_to_single_banks(cuda, shape):
    tile, scal, lw, cols = chip_smoke.user_batched_inputs(*shape, 3, cuda)
    lw_k, ln_k, _ = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    for i in range(shape[0]):
        lw_1, ln_1, _ = b1.fused_bayes_update(tile, scal[i], lw[i],
                                              tuple(c[i] for c in cols))
        assert torch.equal(lw_1, lw_k[i]) and torch.equal(ln_1, ln_k[i])


@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("binomial", [False, True], ids=["two_outcome",
                                                         "binomial"])
def test_traced_route_bit_equal_to_user_functor(cuda, binomial, n):
    """The functor traced from the user model's torch pr1 gives the
    hand-written functor's bits, through the wrapper (counted on the traced
    route) and in each forced form."""
    tile, scal, lw, cols = chip_smoke.user_inputs(binomial, n, n, cuda)
    twin = type(tile)(chip_smoke.LOST_VISIBILITY_TORCH)
    counts = (b1.fused_bayes_update.traced_launches,
              b1.fused_bayes_update.column_launches)
    got = b1.fused_bayes_update(twin, scal, lw, cols)
    assert (b1.fused_bayes_update.traced_launches,
            b1.fused_bayes_update.column_launches) == (counts[0] + 1,
                                                       counts[1])
    want = b1.fused_bayes_update(tile, scal, lw, cols)
    traced = b1._route(twin, scal, cols, lw.shape, batched=False)[0]
    batch = (scal[None], lw[None], tuple(c[None] for c in cols))
    forms = chip_smoke.b1_forms(traced, *batch)
    assert set(forms) == {b1.ONE_LAUNCH, b1.TWO_PASS, "row span"}
    for form, result in forms.items():
        for a, b in zip(result, chip_smoke.b1_forms(tile, *batch)[form]):
            assert torch.equal(a, b), form
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_traced_trial_grid_bit_equal_to_user_functor(cuda, shape):
    tile, scal, lw, cols = chip_smoke.user_batched_inputs(*shape, 3, cuda)
    twin = type(tile)(chip_smoke.LOST_VISIBILITY_TORCH)
    before = b1.fused_bayes_update_batched.traced_launches
    got = b1.fused_bayes_update_batched(twin, scal, lw, cols)
    assert b1.fused_bayes_update_batched.traced_launches == before + 1
    want = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", chip_smoke.BUILTIN_TILES, ids=lambda c: c[0])
def test_traced_builtin_pr1_matches_its_functor(cuda, case):
    """Each built-in tile over its pr1 traced agrees with its built-in
    functor within B1_TOL (chip_smoke prints how many ulp apart)."""
    tile, scal, lw, cols = case[1](N + 3, 5, cuda)
    got = b1.fused_bayes_update(chip_smoke.traced_twin(tile, len(cols)),
                                scal, lw, cols)
    want = b1.fused_bayes_update(tile, scal, lw, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    assert abs(float(got[1]) - float(want[1])) <= 1e-4


def test_malformed_user_source_raises_with_nvcc_message(cuda):
    """A user functor that does not compile raises with nvcc's message at
    its first launch; nothing takes the column route or the plain
    version."""
    bad = b1.cuda_pr1(chip_smoke.lost_visibility_pr1,
                      "struct UserPr1 { this is not C++; };")
    tile, scal, lw, cols = chip_smoke.user_inputs(False, 1000, 1, cuda)
    counts = (b1.fused_bayes_update.launches,
              b1.fused_bayes_update.column_launches)
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        b1.fused_bayes_update(type(tile)(bad), scal, lw, cols)
    assert "error" in str(err.value)
    assert (b1.fused_bayes_update.launches,
            b1.fused_bayes_update.column_launches) == counts


def test_bench_flagship_on_the_card(cuda):
    """bench_torch's flagship at 2^20, two windows and one repeat: every
    window passes bench.py's gate and B1 launches once an update (200)."""
    import bench_torch

    line = bench_torch.flagship(N, 2, 1, 0, cuda)
    assert line["launches"]["B1"] == 2 * bench_torch.N_EXP == 200
    assert line["launches"]["B2"] >= line["n_resamples"] > 0
    assert line["value"] > 0


def test_entry_runs_on_the_card(cuda):
    from qinfer_tpu_torch.entry import entry

    fn, args = entry()
    assert args[0].particle_locations.is_cuda
    launches = b1.fused_bayes_update.launches
    state, log_norm = fn(*args)
    assert b1.fused_bayes_update.launches == launches + 1
    assert bool(torch.isfinite(log_norm))
    assert bool(torch.isfinite(state.particle_log_weights).all())


def test_bench_soak_on_the_card(cuda):
    """bench_torch's soak at 256 × 2048 × 40: its gate, the batched B1 once
    a step, every batched resample through the fused Liu–West launch, the
    bank form with its prologue (``soak`` raises otherwise)."""
    import bench_torch

    line = bench_torch.soak(256, 2048, 40, device=cuda)
    launches = line["launches"]
    assert launches["B1_batched"] == 42
    assert launches["B2_batched"] == launches["B2_unfused_batched"] == 0
    assert launches["B2_fused"] >= line["steps_resampled"] > 0


@pytest.mark.parametrize("name", ["systematic_pick_D1", "liu_west_resample_D1",
                                  "bayes_update_step",
                                  "update_plus_forced_resample"])
def test_bench_breakdown_kernel_lines_on_the_card(cuda, name):
    """The breakdown's lines that reach a kernel, at 2^20: B1 or B2
    exactly once an iteration (``timed_op`` raises otherwise)."""
    import bench_torch

    (line,) = bench_torch.breakdown(N, cuda, names={name})
    assert line["ms"] > 0 and line["gbps"] > 0
    assert sum(line["launches"].values()) > 0


def test_bench_scaling_rows_on_one_rank(cuda):
    """The scaling twin's rows at k = 1 on a one-rank NCCL group: both
    migrations' inventories and the throughput at 2^15 a rank."""
    import bench_torch

    with chip_smoke.nccl_world_one(cuda) as mesh:
        rows = bench_torch.with_efficiency(bench_torch.scaling_rows(
            mesh, (1 << 15,), cuda, n_exp=10, repeats=1))
    inv = {r["migration"]: r for r in rows
           if r["metric"] == "collective_bytes_per_step"}
    assert inv["all_gather"]["launches"] == {"B1": 1, "B2": 1}
    assert inv["ring"]["launches"] == {"B1": 1, "B2": 0}
    assert inv["all_gather"]["collectives"]["all-gather"]["bytes"] == 8 << 15
    assert rows[-1]["weak_scaling_efficiency"] == 1.0


@pytest.mark.parametrize("which", ["config1_precession_quickstart",
                                   "config2_binomial_estimation",
                                   "config3_randomized_benchmarking",
                                   "config5_adaptive_tomography"])
def test_example_twin_on_the_card(cuda, which):
    import importlib

    module = importlib.import_module(f"examples_torch.{which}")
    launches = b1.fused_bayes_update.launches
    module.main(device=cuda)
    assert b1.fused_bayes_update.launches > launches


@pytest.mark.parametrize("run", ["b1_launch", "batch_update", "ensemble"])
def test_program_spans_are_not_mirrored_on_the_card(cuda, run):
    """The program's spans are host ranges of the profiler's trace that it
    does not mirror on the device: no CUDA-typed event carries a
    ``qinfer.`` name, while B1's span and kernel are both in the trace."""
    from torch.profiler import ProfilerActivity, profile

    from qinfer_tpu_torch import profiling

    model = qt.SimplePrecessionModel()
    prior = qt.UniformDistribution([[0, 1]])
    g = torch.Generator(device=cuda).manual_seed(5)
    n_exp = 20
    ts = torch.tensor([1.3 ** k for k in range(n_exp)], device=cuda)
    outcomes = (torch.rand(n_exp, generator=g, device=cuda) < 0.5).to(
        torch.int32)
    state = qt.init_smc_state(g, model, 1 << 16, prior)
    tile = b1.two_outcome_tile(b1.precession_pr1)
    scal = torch.tensor([0.0, 2.0], device=cuda)

    def block():
        if run == "b1_launch":
            b1.fused_bayes_update(tile, scal, state.particle_log_weights,
                                  (state.particle_locations[:, 0],))
        elif run == "batch_update":
            qt.smc_batch_update(model, qt.LiuWestResampler(),
                                qt.SMCConfig(zero_weight_policy="reset"),
                                state, outcomes, {"t": ts})
        else:
            qt.perf_test_multiple(16, model, 512, prior, 5, qt.PGH, seed=5,
                                  device=cuda)
        torch.cuda.synchronize()

    block()  # builds the kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block()
    events = prof.profiler.kineto_results.events()
    on_card = torch.autograd.DeviceType.CUDA
    assert [e.name() for e in events if e.device_type() == on_card
            and e.name().startswith("qinfer.")] == []
    assert any(e.device_type() == on_card and "fused_update" in e.name()
               for e in events)
    host = {e.name() for e in events if e.device_type() != on_card}
    assert "qinfer.ops.b1" in host
    assert set(profiling.recorded()["spans"]) <= host


# Profiles one fused Liu–West launch and prints the card's kernel names.
_PROFILE_FUSED = """
import json, math
import torch
from torch.profiler import ProfilerActivity, profile
from qinfer_tpu_torch.ops import resample_expand as b2

g = torch.Generator(device="cuda").manual_seed(3)
args = (torch.randn((74, 2048), generator=g, device="cuda"),
        torch.rand((74, 2048, 1), generator=g, device="cuda"),
        torch.rand((74,), generator=g, device="cuda"), 0.98,
        math.sqrt(1.0 - 0.98 ** 2))
b2.liu_west_expand_batched(*args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    b2.liu_west_expand_batched(*args)
    torch.cuda.synchronize()
on_card = torch.autograd.DeviceType.CUDA
print(json.dumps([e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == on_card]))
"""


def test_fused_liu_west_is_one_bank_form_kernel(cuda):
    """The wrapper makes one launch, of a kernel whose name holds
    ``expand_bank`` (the name the benchmark's B2 roofline reads). It
    profiles in a process of its own, so that it leaves this process's
    profiler untouched: after one profile, a later short one in the same
    process has read no card events (the span test's single B1 launch)."""
    done = subprocess.run([sys.executable, "-c", _PROFILE_FUSED], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    kernels = json.loads(done.stdout.strip().splitlines()[-1])
    assert len(kernels) == 1 and "expand_bank_liu_west" in kernels[0], kernels


@functools.lru_cache(maxsize=None)
def _psd_cases(name):
    basis = dict(chip_smoke.PSD_BASES)[name]
    cases = chip_smoke.psd_valid_cases(basis, chip_smoke.psd_rows(basis), 31)
    return basis, cases, chip_smoke.min_eigenvalues(basis, cases)


@pytest.mark.parametrize("subnormalized", [False, True],
                         ids=["unit_trace", "subnormalized"])
@pytest.mark.parametrize("view", [False, True], ids=["rows", "view"])
@pytest.mark.parametrize("name", ["pauli2", "gm3", "pauli3"])
def test_psd_valid_kernel_matches_plain_and_eigvalsh(cuda, name, view,
                                                     subnormalized):
    """At 2^20 Liu–West-smeared, boundary and out-of-range rows (2^19 at
    d = 8, the three-qubit bank): one launch a call, and every row whose
    smallest eigenvalue is more than 1e-6 from −psd_tol decided as the
    plain version and f64 eigvalsh decide it
    (``chip_smoke.psd_valid_agreement`` raises otherwise); the borderline
    rows that differ are printed."""
    basis, cases, lam = _psd_cases(name)
    res = chip_smoke.psd_valid_agreement(basis, cases, lam, cuda, view,
                                         subnormalized)
    print(json.dumps({name: res}))
    assert res["decisive"] > 0.99 * res["rows"]
    assert 0.1 * res["rows"] < res["valid"] < 0.9 * res["rows"]


def test_a_two_qubit_resample_tests_through_the_kernel(cuda):
    """Every validity test of a Liu–West resample of a two-qubit bank is a
    launch of a kernel of ``csrc/psd_valid.cu``: the test for the drawn
    bank and the one-launch round for each redraw round; the kernels' rows
    counter equals the resampler's tested rows (the bank, then the rows
    still invalid before each round)."""
    from torch.profiler import ProfilerActivity, profile

    model = tomo.TomographyModel(chip_smoke.PAULI2)
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 1 << 16
    locs = tomo.GinibreDistribution(chip_smoke.PAULI2).sample(g, n)
    log_w = torch.full((n,), -math.log(n), device=cuda)
    launches = pv.psd_valid.launches, pv.psd_redraw.launches
    rounds = qt.LiuWestResampler.redraw_rounds
    kernel_rounds = qt.LiuWestResampler.kernel_rounds
    # The host's activity only: a card trace here would leave a later
    # profile in this process without card events.
    with profile(activities=[ProfilerActivity.CPU]):
        new = qt.LiuWestResampler(a=0.98)(g, model, locs, log_w)
    counters = profiling.recorded()["counters"]
    rounds = qt.LiuWestResampler.redraw_rounds - rounds
    assert rounds > 0
    assert qt.LiuWestResampler.kernel_rounds - kernel_rounds == rounds
    assert counters["resamplers.LiuWestResampler.kernel_rounds"] == rounds
    assert (pv.psd_valid.launches - launches[0],
            pv.psd_redraw.launches - launches[1]) == (1, rounds)
    tested = counters["resamplers.LiuWestResampler.tested_rows"]
    assert counters["ops.psd_valid.rows"] == tested
    assert n < tested < n + rounds * n
    assert bool(model.are_models_valid(new).all())


@pytest.mark.parametrize("name,banks", [
    ("pauli2", 1), ("pauli2", 4), ("gm3", 1), ("gm3", 4), ("pauli3", 1)])
def test_redraw_round_kernel_matches_the_masked_chain(cuda, name, banks):
    """Two one-launch rounds, over the mask then over the list the first
    wrote, against the resampler's masked chain (GEMM, the validity
    kernel, ``where``) at 2^20 rows, one root or one a bank of 2^18 rows
    (d = 8: 2^19 rows, one root), the same noise, mask and roots: rows
    valid before untouched, every decisive row decided alike and the rows
    both wrote within ``chip_smoke.REDRAW_MAX_ULPS`` of the row's scale
    (``chip_smoke.redraw_round_agreement`` raises otherwise), the count
    and list left the mask's; the rows that differ (all borderline) and
    the largest gap of the rows both wrote, in ulps, printed."""
    basis = dict(chip_smoke.PSD_BASES)[name]
    case = chip_smoke.redraw_round_case(basis, chip_smoke.psd_rows(basis),
                                        banks, 41, device=cuda)
    launches = pv.psd_redraw.launches
    res = chip_smoke.redraw_round_agreement(basis, case)
    print(json.dumps({f"redraw_round[{name}, banks={banks}]": res}))
    assert pv.psd_redraw.launches == launches + 2
    # At d = 8 a smear of these centers is a state less often: about one
    # row in twelve of those redrawn.
    taken = 0.1 if basis.dim < 8 else 0.05
    for form in ("mask", "list"):
        r = res[form]
        assert r["decisive"] > 0.99 * r["invalid_before"]
        assert 0 < r["left"] < r["invalid_before"]
        assert r["written_rows"] > taken * r["invalid_before"]
        assert r["max_ulps"] <= chip_smoke.REDRAW_MAX_ULPS


def test_redraw_round_with_no_invalid_row_changes_nothing(cuda):
    basis = chip_smoke.PAULI2
    locs, ok, centers, roots, noise = chip_smoke.redraw_round_case(
        basis, 1 << 16, 1, 42, device=cuda)
    ok[:] = True
    got, got_ok = locs.clone(), ok.clone()
    left, _ = pv.psd_redraw(got, got_ok, centers, roots[0], noise, 0, None,
                            basis, chip_smoke.PSD_TOL)
    assert int(left) == 0
    assert torch.equal(got, locs) and bool(got_ok.all())


@pytest.mark.parametrize("banks", [1, 4])
def test_liu_west_loop_with_the_round_kernel_against_the_masked_chain(
        cuda, banks):
    """The resampler's postselection on a two-qubit bank of 2^18 rows (one
    bank, or four of 2^16 with their own roots), the draws injected: the
    one-launch rounds against the masked chain take the same rows in the
    same rounds, but for borderline rows (counted; the others within the
    smear's rounding), each round one draw of the whole bank; every row a
    state."""
    basis = chip_smoke.PAULI2
    model = qt.BinomialModel(tomo.TomographyModel(basis))
    n = (1 << 18) // banks
    _, _, centers, roots, _ = chip_smoke.redraw_round_case(
        basis, banks * n, banks, 43, device=cuda)
    shape = (banks, n, 16) if banks > 1 else (n, 16)
    centers = centers.reshape(shape)
    root = roots if banks > 1 else roots[0]
    g = torch.Generator(device=cuda).manual_seed(44)
    draws = [torch.randn(shape, generator=g, device=cuda)
             for _ in range(17)]
    seen = []

    def kernel(generator, shp):
        seen.append(shp)
        return draws[len(seen) - 1]

    rs = qt.LiuWestResampler(kernel=kernel)
    kernel_rounds = qt.LiuWestResampler.kernel_rounds
    got = rs._postselect(model, None, centers, root)
    rounds = qt.LiuWestResampler.kernel_rounds - kernel_rounds
    calls = list(seen)
    seen.clear()
    want = chip_smoke.masked_chain_postselect(
        model, lambda: chip_smoke._smear_banks(
            centers.reshape(-1, 16), roots, kernel(None, shape)
            .reshape(-1, 16)), rs.maxiter)
    assert calls == seen == [shape] * (1 + rounds) and rounds > 1
    # A row taken in another round, or clamped on one side only, lies
    # further off than the smear's rounding.
    differ = int(((got - want).abs().amax(1) > 1e-5).sum())
    print(json.dumps({f"liu_west_loop[banks={banks}]": {
        "rows": banks * n, "rounds": rounds, "rows_differ": differ,
        "rows_not_bit_equal": int((got != want).any(1).sum())}}))
    assert differ <= 1e-4 * banks * n
    assert bool(model.are_models_valid(got).all())
