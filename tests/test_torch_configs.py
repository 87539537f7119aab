"""Whole runs of BASELINE configs 2–5 through the port against the JAX
package (CPU, N = 4096).

The records and gates are ``chip_smoke.CONFIGS``, the ones the card runs
at 2^20. Both packages start from the same initial cloud (carried across
with ``interop``) and then draw from their own random streams, so each
posterior mean is compared within five joint posterior standard
deviations plus the f32 resolution, as ``test_torch_smc.py`` does for the
flagship path; config 2 is also held against the f64 oracle.

Config 5 (``chip_smoke.config5_window``, adaptive qubit tomography) runs
through the port; the JAX ``SMCUpdater`` replays the effects the port chose
and the outcomes it drew, and the posterior means are compared the same
way. The port's first EIG, on the shared initial cloud, equals the JAX
package's. Two-qubit binomial tomography
(``chip_smoke.tomography_2q_window``) runs in both packages from shared
clouds of four seeds, and the means over the seeds are compared within
the standard error that the seeds' spread gives.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import OracleBinomialPrecession, OracleSMC

import qinfer_tpu as qi
import qinfer_tpu.tomography as jt
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 4096
JAX_MODELS = {
    "config2_binomial_precession":
        qi.BinomialModel(qi.SimplePrecessionModel()),
    "config3_binomial_rb": qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel()),
    "config4_multicos2": qi.MultiCosModel(n_terms=2),
    "config4_known_t2": qi.KnownT2PrecessionModel(t2=100.0),
}


@pytest.fixture(scope="module", params=chip_smoke.CONFIGS,
                ids=lambda make: make.__name__)
def runs(request):
    cfg = request.param()
    model_j = JAX_MODELS[cfg.name]
    assert type(from_reference(model_j)) is type(cfg.model)
    ju = qi.SMCUpdater(model_j, N, qi.UniformDistribution(cfg.prior),
                       zero_weight_policy="reset", seed=0)
    state0 = jax.tree_util.tree_map(np.asarray, ju.state)
    ju.batch_update(cfg.outcomes, cfg.expparams)
    tu = qt.SMCUpdater(cfg.model, N, qt.UniformDistribution(cfg.prior),
                       zero_weight_policy="reset", seed=0, device="cpu")
    tu.state = state_from_numpy(state0)
    tu.batch_update(cfg.outcomes, cfg.expparams)
    return cfg, ju, tu


def test_config_passes_its_gate(runs):
    cfg, _, tu = runs
    locs = tu.particle_locations.numpy()
    assert locs.shape == (N, cfg.model.n_modelparams)
    assert np.all(np.isfinite(locs))
    ok, est, sd = cfg.gate(tu.est_mean().numpy(),
                           tu.est_covariance_mtx().numpy())
    assert ok, (cfg.name, est, sd)
    assert tu.resample_count > 0
    assert len(tu.normalization_record) == len(cfg.outcomes)


def test_config_matches_jax_by_moments(runs):
    cfg, ju, tu = runs
    mean_t, cov_t = tu.est_mean().numpy(), tu.est_covariance_mtx().numpy()
    mean_j = np.asarray(ju.est_mean())
    cov_j = np.asarray(ju.est_covariance_mtx())
    var_t, var_j = np.diag(cov_t), np.diag(cov_j)
    assert np.all(np.abs(mean_t - mean_j) < 5 * np.sqrt(var_t + var_j) + 1e-6)
    assert np.all((0.2 < var_t / var_j) & (var_t / var_j < 5.0))
    # Same initial cloud: the first update's evidence agrees.
    np.testing.assert_allclose(tu.normalization_record[0],
                               ju.normalization_record[0], rtol=1e-4)


def test_config2_matches_the_oracle():
    cfg = chip_smoke.config2_binomial_precession()
    tu = qt.SMCUpdater(cfg.model, N, qt.UniformDistribution(cfg.prior),
                       zero_weight_policy="reset", seed=1, device="cpu")
    tu.batch_update(cfg.outcomes, cfg.expparams)
    rng = np.random.default_rng(0)
    oracle = OracleSMC(OracleBinomialPrecession(40), N,
                       lambda k: rng.random((k, 1)), rng)
    for k, t in zip(cfg.outcomes, cfg.expparams["t"]):
        oracle.update(int(k), float(t))
    est_t = float(tu.est_mean()[0])
    var_t = float(tu.est_covariance_mtx()[0, 0])
    est_o, var_o = float(oracle.est_mean()[0]), float(oracle.est_cov()[0, 0])
    assert abs(est_t - est_o) < 5 * np.sqrt(var_t + var_o) + 1e-6
    assert 0.2 < var_t / var_o < 5.0


def _assert_means_agree(tu, ju):
    mean_t, cov_t = tu.est_mean().numpy(), tu.est_covariance_mtx().numpy()
    mean_j = np.asarray(ju.est_mean())
    var_t = np.diag(cov_t)
    var_j = np.diag(np.asarray(ju.est_covariance_mtx()))
    assert np.all(np.abs(mean_t - mean_j)
                  < 5 * np.sqrt(var_t + var_j) + 1e-6), (mean_t, mean_j)


def test_config5_adaptive_tomography_matches_jax():
    """The port's adaptive loop, replayed through the JAX SMCUpdater."""
    ju = qi.SMCUpdater(jt.TomographyModel(jt.pauli_basis(1)), N,
                       jt.GinibreDistribution(jt.pauli_basis(1)),
                       zero_weight_policy="reset", seed=0)
    tu = chip_smoke.config5_updater(N, 0, torch.device("cpu"))
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    cand = {"meas": chip_smoke.EFFECTS_1Q}
    ig0_j = np.asarray(ju.expected_information_gain(cand))
    w = chip_smoke.config5_window(tu, 0)
    np.testing.assert_allclose(w["igs"][0], ig0_j, rtol=1e-4, atol=1e-6)
    ok, err, spread = chip_smoke.config5_gate(w)
    assert ok, (err, spread)
    assert len(w["choices"]) == chip_smoke.N_STEPS_1Q
    assert sorted(set(w["choices"])) == [0, 1, 2]
    for k, outcome in zip(w["choices"], w["outcomes"]):
        ju.update(jnp.int32(outcome),
                  {"meas": jnp.asarray(chip_smoke.EFFECTS_1Q[k])[None]})
    assert tu.resample_count > 0 and ju.resample_count > 0
    _assert_means_agree(tu, ju)


SEEDS_2Q = (0, 1, 2, 3)
K_2Q = 4.0  # standard errors of the difference of the two means over seeds


def test_tomography_2q_binomial_matches_jax():
    """One batch_update over the two-qubit record in both packages, for
    each of ``SEEDS_2Q`` from a shared initial cloud. The posterior there
    is impoverished (15 parameters, ≈ 21 resamples at N = 4096), so two
    honest runs of one seed differ by more than their own posterior
    spreads: the means are compared over the seeds instead, the mean of
    the port's M posterior means against the JAX package's within K_2Q
    standard errors measured from the seeds' spread,
    √(var_t/M + var_j/M), plus the f32 resolution."""
    _, _, meas, counts = chip_smoke.tomography_2q_record()
    expparams = {k: jnp.asarray(v) for k, v in
                 chip_smoke.tomography_2q_expparams(meas).items()}
    means_t, means_j = [], []
    for seed in SEEDS_2Q:
        ju = qi.SMCUpdater(
            qi.BinomialModel(jt.TomographyModel(jt.pauli_basis(2))), N,
            jt.GinibreDistribution(jt.pauli_basis(2)),
            zero_weight_policy="reset", seed=seed)
        tu = chip_smoke.tomography_2q_updater(N, seed, torch.device("cpu"))
        tu.state = state_from_numpy(
            jax.tree_util.tree_map(np.asarray, ju.state))
        w = chip_smoke.tomography_2q_window(tu)
        ok, overlap = chip_smoke.tomography_2q_gate(w)
        assert ok, (seed, overlap)
        ju.batch_update(jnp.asarray(counts), expparams)
        np.testing.assert_allclose(tu.normalization_record[0],
                                   ju.normalization_record[0], rtol=1e-4)
        means_t.append(tu.est_mean().numpy())
        means_j.append(np.asarray(ju.est_mean()))
    means_t, means_j = np.array(means_t), np.array(means_j)
    m = len(SEEDS_2Q)
    stderr = np.sqrt(np.var(means_t, axis=0, ddof=1) / m
                     + np.var(means_j, axis=0, ddof=1) / m)
    diff = np.abs(means_t.mean(axis=0) - means_j.mean(axis=0))
    assert np.all(diff < K_2Q * stderr + 1e-6), (diff, stderr)
