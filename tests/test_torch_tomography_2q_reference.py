"""Two-qubit binomial tomography in the port against its plain float64
reference (``reference_tomography_2q.py``, a copy of the benchmark's
``benchmark/reference/tomography_2q.py``), on the CPU at N = 4096, on
seeded banks, projectors and counts:

- one binomial update's weights and log evidence, on B1's plain version
  and on the unfused path: f32 rounding, 1e-5 of the largest weight and
  1e-5 in the log evidence;
- ``are_models_valid`` against complex ``eigvalsh``, also on rows within
  1e-6 of the PSD boundary and on near-low-rank states, where the
  characteristic polynomial's coefficients have no sign in f32: equal
  wherever the lowest eigenvalue lies more than 2e-6 (≈ 7 times the
  factorization's f32 rounding) from −psd_tol;
- ``canonicalize`` against the reference's projection: 1e-6 (f32 rounding
  of an eigendecomposition);
- one Liu–West resample with the stratum offset and the smear's draws
  injected, against the reference with the same draws: weights on a grid
  of 1/N and an offset of 1/2 keep every parent an exact choice, so the
  banks agree row by row to f32 rounding (2e-6);
- a record given to ``smc_batch_update`` whole and in slices: bit-equal;
- the reference's update computed in bfloat16 (the benchmark's control):
  over the benchmark's limits of 1e-3.
"""

import dataclasses
import filecmp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qinfer_tpu_torch as qt
import reference_tomography_2q as ref
from qinfer_tpu_torch import smc, tomography as tomo

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
N = 4096
N_SHOTS = 50
TOL = 1e-5
BASIS = tomo.pauli_basis(2)
F64 = torch.float64


def _model():
    return qt.BinomialModel(tomo.TomographyModel(BASIS))


def _bank(seed, n=N):
    g = torch.Generator().manual_seed(seed)
    return tomo.GinibreDistribution(BASIS).sample(g, n), g


def _effects(seed, n):
    """``n`` product projectors |a⟩⟨a| ⊗ |b⟩⟨b|, coordinates f32."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 2, 2)) + 1j * rng.standard_normal((n, 2, 2))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p = np.einsum("nsi,nsj->nsij", v, v.conj())
    proj = np.einsum("nij,nkl->nikjl", p[:, 0], p[:, 1]).reshape(n, 4, 4)
    return ref.coords(torch.from_numpy(proj)).to(torch.float32)


def _with_lowest(seed, lowest, others=None):
    """States of f64 spectra whose lowest eigenvalue is ``lowest`` (the
    others random, or ``others``), in random bases; trace 1."""
    rng = np.random.default_rng(seed)
    n = len(lowest)
    z = rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))
    q, _ = np.linalg.qr(z)
    if others is None:
        others = rng.uniform(0.05, 1.0, (n, 3))
    others = np.asarray(others, np.float64)
    others = others / others.sum(1, keepdims=True) * (1.0 - np.asarray(
        lowest))[:, None]
    lam = np.concatenate([np.asarray(lowest)[:, None], others], 1)
    rho = np.einsum("nij,nj,nkj->nik", q, lam, q.conj())
    return ref.coords(torch.from_numpy(rho))


def test_the_reference_is_the_benchmark_s_copy():
    bench = HERE.parent / "benchmark" / "reference" / "tomography_2q.py"
    assert filecmp.cmp(bench, HERE / "reference_tomography_2q.py",
                       shallow=False)


def test_the_reference_loads_nothing_of_the_system():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch, reference_tomography_2q\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qinfer_tpu_torch', 'qinfer_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(bad, torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32)\n" % str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[] False False"


def test_the_reference_basis_is_the_port_s():
    np.testing.assert_array_equal(ref.basis().numpy(), BASIS.data)
    x, _ = _bank(0, 64)
    np.testing.assert_allclose(ref.coords(ref.density(x)).numpy(),
                               x.numpy(), atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_one_binomial_update_matches_the_reference(fused):
    locs, g = _bank(1)
    log_w = torch.log_softmax(torch.randn(N, generator=g), 0)
    effects = _effects(2, 6)
    state = smc.init_smc_state(g, _model(), N, tomo.GinibreDistribution(
        BASIS))
    config = smc.SMCConfig(resample_thresh=0.0, zero_weight_policy="reset",
                           use_fused_update=fused)
    for j, effect in enumerate(effects):
        k = [0, 3, 9, 14, 20, 27][j]
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


def test_validity_matches_eigvalsh_at_the_boundary():
    near = [-1e-6, -5e-7, 0.0, 5e-7, 1e-6]  # within 1e-6 of ρ ⪰ 0
    over = [-1.3e-5, -3e-5, -1e-4, -1e-3, -1e-2]  # below −psd_tol
    lowest = np.array(near * 40 + over * 40)
    # Near-low-rank states, as the two-qubit posterior's: one eigenvalue
    # 0.9 and two more small ones.
    low_rank = _with_lowest(4, lowest, np.tile([0.92, 0.03, 0.05],
                                                (len(lowest), 1)))
    x = torch.cat([_with_lowest(3, lowest), low_rank]).to(torch.float32)
    x64 = x.to(F64)
    lam = ref.lowest_eigenvalues(x64)
    model = tomo.TomographyModel(BASIS)
    got = model.are_models_valid(x).numpy()
    want = (lam >= -TOL).numpy()
    decisive = (torch.abs(lam + TOL) > 2e-6).numpy()
    assert decisive.mean() > 0.8 and want[decisive].mean() > 0.4
    np.testing.assert_array_equal(got[decisive], want[decisive])
    # Ginibre states and the same smeared.
    locs, g = _bank(5)
    y = locs + 0.03 * torch.randn(N, 16, generator=g) * torch.cat(
        [torch.zeros(1), torch.ones(15)])
    lam = ref.lowest_eigenvalues(y.to(F64))
    decisive = (torch.abs(lam + TOL) > 2e-6).numpy()
    got = model.are_models_valid(y).numpy()
    bad = ref.invalid_rows(y, TOL, 2e-4).numpy()
    np.testing.assert_array_equal(got[decisive], ~bad[decisive])
    assert 0.2 < got.mean() < 0.8


def test_canonicalize_matches_the_reference_projection():
    locs, g = _bank(6, 512)
    y = locs.clone()
    y[:, 1:] *= 1.0 + 2.0 * torch.rand(512, 1, generator=g)
    model = tomo.TomographyModel(BASIS)
    got = model.canonicalize(y)
    want = ref.project(y, TOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert ref.invalid(got, TOL + 1e-6, 2e-4 + 1e-6) == 0
    assert bool(model.are_models_valid(got).all())


def test_liu_west_matches_the_reference_with_the_same_draws():
    locs, g = _bank(7)
    # Weights on a grid of 1/N: with the offset 1/2 every stratum lies
    # half a stratum from every boundary of the CDF.
    k = torch.multinomial(torch.rand(N, generator=g), N, replacement=True,
                          generator=g)
    counts = torch.bincount(k, minlength=N).to(F64)
    log_w = torch.log(counts / N).to(torch.float32)
    draws = [torch.randn(N, 16, generator=g) for _ in range(17)]
    seen = []

    def kernel(generator, shape):
        seen.append(shape)
        return draws[len(seen) - 1]

    for maxiter in (16, 1):
        seen.clear()
        rs = qt.LiuWestResampler(a=0.98, maxiter=maxiter, kernel=kernel)
        got = rs(None, _model(), locs, log_w, u0=0.5)
        used = []

        def noise(shape):
            used.append(shape)
            return draws[len(used) - 1]

        want = ref.liu_west(locs, counts / N, 0.98, maxiter, TOL, 2e-4, None,
                            u0=0.5, noise=noise)
        assert len(used) == len(seen) > 1
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-6)
        assert ref.invalid(got, TOL + 1e-6, 2e-4 + 1e-6) == 0


def test_a_record_in_slices_is_bit_equal_to_the_whole():
    model = _model()
    effects = _effects(8, 40)
    truth = _with_lowest(9, [0.025], [[0.9, 0.025, 0.05]])[0]
    rng = np.random.default_rng(10)
    counts = torch.as_tensor(rng.binomial(
        N_SHOTS, np.clip(effects.double().numpy() @ truth.numpy(), 0, 1)),
        dtype=torch.int32)
    ep = {"meas": effects, "n_meas": torch.full((40,), N_SHOTS,
                                                 dtype=torch.int32)}
    config = smc.SMCConfig(resample_thresh=0.5, zero_weight_policy="reset")
    rs = qt.LiuWestResampler(a=0.98, maxiter=16)
    prior = tomo.GinibreDistribution(BASIS)

    def run(bounds):
        state = smc.init_smc_state(torch.Generator().manual_seed(11), model,
                                   N, prior)
        norms = []
        for a, b in zip(bounds, bounds[1:]):
            state, ln = smc.smc_batch_update(
                model, rs, config, state, counts[a:b],
                {k: v[a:b] for k, v in ep.items()})
            norms.append(ln)
        return state, torch.cat(norms)

    whole, ln_whole = run([0, 40])
    split, ln_split = run([0, 3, 4, 17, 18, 30, 31, 40])
    assert int(whole.n_resamples) > 3
    assert torch.equal(ln_whole, ln_split)
    for f in ("particle_locations", "particle_log_weights", "n_resamples",
              "min_n_ess", "log_total_likelihood"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f


def test_the_bfloat16_control_is_far_off():
    locs, g = _bank(12)
    log_w = torch.log_softmax(torch.randn(N, generator=g), 0)
    effect = _effects(13, 1)[0]
    w, ln = ref.update(locs, log_w, effect, N_SHOTS, 21)
    w_c, ln_c = ref.update(locs, log_w, effect, N_SHOTS, 21, torch.bfloat16)
    assert abs(float(ln_c) - float(ln)) > 1e-3
    assert float(torch.max(torch.abs(w_c.to(F64) - w)) / w.max()) > 1e-3
