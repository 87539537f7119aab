"""Three-qubit binomial tomography in the port against its plain float64
reference (the benchmark's ``benchmark/reference/tomography_3q.py``,
imported as it is), on the CPU at N = 4096, on seeded banks, projectors
and counts:

- one binomial update's weights and log evidence, on B1's plain version
  (64 columns) and on the unfused path: f32 rounding, 1e-5 of the largest
  weight and 1e-5 in the log evidence;
- ``are_models_valid`` (a CPU bank's plain LDLᴴ chain at d = 8) against
  complex ``eigvalsh``: equal wherever the lowest eigenvalue lies more than
  4e-6 (≈ 7 times the factorization's f32 rounding at d = 8) from
  −psd_tol;
- ``canonicalize`` (the 16 × 16 ``eigh`` clamp) against the reference's
  projection: 2e-6 (f32 rounding of an eigendecomposition);
- one Liu–West resample with the stratum offset and the smear's draws
  injected (the ``kernel=`` hook), against the reference with the same
  draws: weights on a grid of 1/N and an offset of 1/2 keep every parent
  an exact choice, so the banks agree row by row to f32 rounding (4e-6,
  a 64-term smear); a resample whose rounds run out counts one clamped
  resample;
- a record given to ``smc_batch_update`` whole and in slices: bit-equal
  (the benchmark's driver cuts its checked records so);
- the step's route for a CUDA bank (``smc._b1_spec``): B1 for every
  built-in functor up to ``MAX_COLS`` columns, the unfused update, counted,
  over it;
- the reference's update computed in bfloat16 (the benchmark's control):
  over the benchmark's limits of 1e-3.
"""

import dataclasses
import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import smc, tomography as tomo
from qinfer_tpu_torch.ops import fused_update as b1

torch.set_num_threads(2)

REF_PATH = (Path(__file__).resolve().parent.parent / "benchmark"
            / "reference" / "tomography_3q.py")
_spec = importlib.util.spec_from_file_location("_reference_tomography_3q",
                                               REF_PATH)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

N = 4096
N_SHOTS = 50
TOL = 1e-5
TRACE_TOL = ref.math.sqrt(8.0) * 1e-4
BASIS = tomo.pauli_basis(3)
F64 = torch.float64


def _model():
    return qt.BinomialModel(tomo.TomographyModel(BASIS, psd_tol=TOL))


def _bank(seed, n=N):
    g = torch.Generator().manual_seed(seed)
    return tomo.GinibreDistribution(BASIS).sample(g, n), g


def _effects(seed, n):
    """``n`` product projectors |a⟩⟨a| ⊗ |b⟩⟨b| ⊗ |c⟩⟨c|, coordinates
    f32."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3, 2)) + 1j * rng.standard_normal((n, 3, 2))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p = np.einsum("nsi,nsj->nsij", v, v.conj())
    proj = np.einsum("nij,nkl,nmo->nikmjlo", p[:, 0], p[:, 1],
                     p[:, 2]).reshape(n, 8, 8)
    return ref.coords(torch.from_numpy(proj)).to(torch.float32)


def _with_lowest(seed, lowest, others=None):
    """States of f64 spectra whose lowest eigenvalue is ``lowest`` (the
    other seven random, or ``others``), in random bases; trace 1."""
    rng = np.random.default_rng(seed)
    n = len(lowest)
    z = rng.standard_normal((n, 8, 8)) + 1j * rng.standard_normal((n, 8, 8))
    q, _ = np.linalg.qr(z)
    if others is None:
        others = rng.uniform(0.05, 1.0, (n, 7))
    others = np.asarray(others, np.float64)
    others = others / others.sum(1, keepdims=True) * (1.0 - np.asarray(
        lowest))[:, None]
    lam = np.concatenate([np.asarray(lowest)[:, None], others], 1)
    rho = np.einsum("nij,nj,nkj->nik", q, lam, q.conj())
    return ref.coords(torch.from_numpy(rho))


def test_the_reference_loads_nothing_of_the_system():
    code = (
        "import importlib.util, sys, torch\n"
        "spec = importlib.util.spec_from_file_location('r', %r)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qinfer_tpu_torch', 'qinfer_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(bad, torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32)\n" % str(REF_PATH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[] False False"


def test_the_reference_basis_is_the_port_s():
    # The port's basis is complex64 (1/√8 rounded), the reference's f64.
    np.testing.assert_allclose(ref.basis().numpy(), BASIS.data, rtol=0,
                               atol=1e-7)
    assert BASIS.labels[16 * 1 + 4 * 2 + 3] == "XYZ"  # first qubit slowest
    x, _ = _bank(0, 64)
    np.testing.assert_allclose(ref.coords(ref.density(x)).numpy(),
                               x.numpy(), atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_one_binomial_update_matches_the_reference(fused):
    locs, g = _bank(1)
    log_w = torch.log_softmax(torch.randn(N, generator=g), 0)
    effects = _effects(2, 4)
    state = smc.init_smc_state(g, _model(), N, tomo.GinibreDistribution(
        BASIS))
    config = smc.SMCConfig(resample_thresh=0.0, zero_weight_policy="reset",
                           use_fused_update=fused)
    for j, effect in enumerate(effects):
        k = [0, 4, 9, 16][j]
        state = dataclasses.replace(state, particle_locations=locs,
                                    particle_log_weights=log_w)
        after, ln = smc.smc_update_step(
            _model(), qt.LiuWestResampler(), config, state,
            torch.tensor(k), {"meas": effect[None],
                              "n_meas": torch.tensor([N_SHOTS])})
        w_ref, ln_ref = ref.update(locs, log_w, effect, N_SHOTS, k)
        assert int(after.n_zero_weight_events) == 0
        w = torch.exp(after.particle_log_weights.to(F64))
        assert float(torch.max(torch.abs(w - w_ref)) / w_ref.max()) < 1e-5
        assert abs(float(ln) - float(ln_ref)) < 1e-5, (k, float(ln),
                                                        float(ln_ref))


def test_b1_plain_version_at_64_columns_matches_the_reference():
    """B1's plain version on the Born tile's 64 columns, as the card's
    kernel takes them (views of the row-major bank), against the
    reference's update; the wrapper takes the tile's 64 columns."""
    locs, g = _bank(3)
    log_w = torch.log_softmax(torch.randn(N, generator=g), 0)
    effect = _effects(4, 1)[0]
    ep = {"meas": effect[None], "n_meas": torch.tensor([N_SHOTS])}
    tile, scalars, cols = _model().fused_spec(torch.tensor(19), locs, ep)
    assert len(cols) == 64 and b1._row_span(cols) == (64, list(range(64)))
    assert len(cols) <= b1.MAX_COLS
    lw, log_norm, _ = b1.fused_bayes_update(tile, scalars, log_w, cols)
    w_ref, ln_ref = ref.update(locs, log_w, effect, N_SHOTS, 19)
    w = torch.exp(lw.to(F64))
    assert float(torch.max(torch.abs(w - w_ref)) / w_ref.max()) < 1e-5
    assert abs(float(log_norm) - float(ln_ref)) < 1e-5
    # The Born sum runs in column order, rounded term by term.
    acc = locs[:, 0] * effect[0]
    for d in range(1, 64):
        acc = acc + locs[:, d] * effect[d]
    assert torch.equal(b1.make_born_pr1(64)(scalars, 3, *cols),
                       torch.clamp(acc, 0.0, 1.0))


def test_validity_matches_eigvalsh_at_the_boundary():
    near = [-2e-6, -1e-6, 0.0, 1e-6, 2e-6]  # within 2e-6 of ρ ⪰ 0
    over = [-1.6e-5, -3e-5, -1e-4, -1e-3, -1e-2]  # below −psd_tol
    lowest = np.array(near * 30 + over * 30)
    # Near-low-rank states, as the GHZ posterior's: one eigenvalue 0.9.
    low_rank = _with_lowest(5, lowest, np.tile([0.9] + [0.1 / 6] * 6,
                                               (len(lowest), 1)))
    x = torch.cat([_with_lowest(6, lowest), low_rank]).to(torch.float32)
    lam = ref.lowest_eigenvalues(x.to(F64))
    model = tomo.TomographyModel(BASIS, psd_tol=TOL)
    got = model.are_models_valid(x).numpy()
    want = (lam >= -TOL).numpy()
    decisive = (torch.abs(lam + TOL) > 4e-6).numpy()
    assert decisive.mean() > 0.8 and want[decisive].mean() > 0.4
    np.testing.assert_array_equal(got[decisive], want[decisive])
    # Ginibre states and the same smeared.
    locs, g = _bank(7)
    y = locs + 0.003 * torch.randn(N, 64, generator=g) * torch.cat(
        [torch.zeros(1), torch.ones(63)])
    lam = ref.lowest_eigenvalues(y.to(F64))
    decisive = (torch.abs(lam + TOL) > 4e-6).numpy()
    got = model.are_models_valid(y).numpy()
    bad = ref.invalid_rows(y, TOL, TRACE_TOL).numpy()
    np.testing.assert_array_equal(got[decisive], ~bad[decisive])
    assert 0.2 < got.mean() < 0.8


def test_canonicalize_matches_the_reference_projection():
    locs, g = _bank(8, 512)
    y = locs.clone()
    y[:, 1:] *= 1.0 + 2.0 * torch.rand(512, 1, generator=g)
    model = tomo.TomographyModel(BASIS, psd_tol=TOL)
    got = model.canonicalize(y)
    want = ref.project(y, TOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    assert ref.invalid(got, TOL + 1e-6, TRACE_TOL + 1e-6) == 0
    assert bool(model.are_models_valid(got).all())


def test_liu_west_matches_the_reference_with_the_same_draws():
    locs, g = _bank(9)
    # Weights on a grid of 1/N: with the offset 1/2 every stratum lies
    # half a stratum from every boundary of the CDF.
    k = torch.multinomial(torch.rand(N, generator=g), N, replacement=True,
                          generator=g)
    counts = torch.bincount(k, minlength=N).to(F64)
    log_w = torch.log(counts / N).to(torch.float32)
    draws = [torch.randn(N, 64, generator=g) for _ in range(17)]
    seen = []

    def kernel(generator, shape):
        seen.append(shape)
        return draws[len(seen) - 1]

    for maxiter in (16, 1):
        seen.clear()
        clamped = qt.LiuWestResampler.clamped_resamples
        rs = qt.LiuWestResampler(a=0.98, maxiter=maxiter, kernel=kernel)
        got = rs(None, _model(), locs, log_w, u0=0.5)
        used = []

        def noise(shape):
            used.append(shape)
            return draws[len(used) - 1]

        want = ref.liu_west(locs, counts / N, 0.98, maxiter, TOL, TRACE_TOL,
                            None, u0=0.5, noise=noise)
        assert len(used) == len(seen) > 1
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=4e-6)
        assert ref.invalid(got, TOL + 1e-6, TRACE_TOL + 1e-6) == 0
        # A resample whose rounds run out clamps once: one round always
        # leaves rows invalid here.
        assert qt.LiuWestResampler.clamped_resamples - clamped in (
            (1,) if maxiter == 1 else (0, 1))


def test_a_record_in_slices_is_bit_equal_to_the_whole():
    model = _model()
    effects = _effects(10, 30)
    truth = _with_lowest(11, [0.0125], [[0.9] + [0.0125] * 6])[0]
    rng = np.random.default_rng(12)
    counts = torch.as_tensor(rng.binomial(
        N_SHOTS, np.clip(effects.double().numpy() @ truth.numpy(), 0, 1)),
        dtype=torch.int32)
    ep = {"meas": effects, "n_meas": torch.full((30,), N_SHOTS,
                                                 dtype=torch.int32)}
    config = smc.SMCConfig(resample_thresh=0.5, zero_weight_policy="reset")
    rs = qt.LiuWestResampler(a=0.98, maxiter=16)
    prior = tomo.GinibreDistribution(BASIS)

    def run(bounds):
        state = smc.init_smc_state(torch.Generator().manual_seed(13), model,
                                   N, prior)
        norms = []
        for a, b in zip(bounds, bounds[1:]):
            state, ln = smc.smc_batch_update(
                model, rs, config, state, counts[a:b],
                {k: v[a:b] for k, v in ep.items()})
            norms.append(ln)
        return state, torch.cat(norms)

    whole, ln_whole = run([0, 30])
    split, ln_split = run([0, 3, 4, 5, 6, 17, 18, 30])
    assert int(whole.n_resamples) > 3
    assert torch.equal(ln_whole, ln_split)
    for f in ("particle_locations", "particle_log_weights", "n_resamples",
              "min_n_ess", "log_total_likelihood"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f


def _given(scalars, off, *cols):
    return cols[0]


@pytest.mark.parametrize("pr1,n_cols,fused", [
    (b1.make_born_pr1(64), 64, True),    # three qubits
    (b1.make_born_pr1(65), 65, False),   # over MAX_COLS
    (b1.make_born_pr1(16), 16, True),    # two qubits
    (b1.make_multicos_pr1(8), 8, True),
    (b1.make_multicos_pr1(9), 9, True),  # MultiCos's wide instantiation
    (b1.make_multicos_pr1(65), 65, False),
    (b1.precession_pr1, 1, True),
    (_given, 200, True),  # no functor: traced or the column route
], ids=["born64", "born65", "born16", "multicos8", "multicos9",
        "multicos65", "precession", "no_functor"])
def test_the_step_sends_only_a_functor_over_max_cols_unfused(pr1, n_cols,
                                                              fused):
    """``_b1_spec`` on one bank and on T banks that say they are on CUDA:
    every built-in functor takes up to ``MAX_COLS`` columns, so only a
    functor's tile over it takes the unfused update, decided from the
    column count before B1 launches and counted as ``unfused_wide`` on the
    wrapper the step would have called; a pr1 without a functor runs
    traced or on the column route at any width."""
    config = smc.SMCConfig(resample_thresh=0.5, zero_weight_policy="reset")
    cols = tuple(torch.rand(8) for _ in range(n_cols))
    spec = (b1.binomial_tile(pr1), torch.rand(3 + n_cols), cols)
    shim = types.SimpleNamespace(
        fused_update_supported=True,
        fused_spec=lambda outcome, bank, ep: spec,
        fused_spec_batched=lambda outcomes, bank, ep: spec)
    for ndim, wrapper in ((2, b1.fused_bayes_update),
                          (3, b1.fused_bayes_update_batched)):
        on_card = types.SimpleNamespace(is_cuda=True, ndim=ndim)
        before = wrapper.unfused_wide
        got = smc._b1_spec(shim, config, on_card, torch.ones(1), {})
        assert (got is spec) is fused
        assert wrapper.unfused_wide == before + (not fused)


@pytest.mark.parametrize("n_terms", [8, 10, 65])
def test_a_cpu_bank_takes_b1_at_any_width(n_terms):
    """On a CPU bank the step runs B1's plain version only when asked
    (``use_fused_update=True``), and then at any width; by default it runs
    the unfused update."""
    model = qt.MultiCosModel(n_terms=n_terms)
    locs = torch.rand(64, n_terms)
    ep = {"ts": torch.rand(1, n_terms)}
    outcomes = torch.ones(1, dtype=torch.int32)
    config = smc.SMCConfig(resample_thresh=0.5, zero_weight_policy="reset")
    assert smc._b1_spec(model, config, locs, outcomes, ep) is None
    forced = dataclasses.replace(config, use_fused_update=True)
    assert len(smc._b1_spec(model, forced, locs, outcomes, ep)[2]) == n_terms


def test_the_bfloat16_control_is_far_off():
    locs, g = _bank(14)
    log_w = torch.log_softmax(torch.randn(N, generator=g), 0)
    effect = _effects(15, 1)[0]
    w, ln = ref.update(locs, log_w, effect, N_SHOTS, 21)
    w_c, ln_c = ref.update(locs, log_w, effect, N_SHOTS, 21, torch.bfloat16)
    assert abs(float(ln_c) - float(ln)) > 1e-3
    assert float(torch.max(torch.abs(w_c.to(F64) - w)) / w.max()) > 1e-3
