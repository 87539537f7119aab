"""Time-dependent models of the port against the JAX package (CPU):
``RandomWalkModel`` and ``GaussianRandomWalkModel``'s ``update_timestep``
and its place in the SMC step.

The deterministic part of a timestep is compared exactly: a random walk
whose step distribution is a ``ConstantDistribution`` moves every row by
the same vector in both packages, bit for bit, and a Gaussian walk keeps
σ and the σ = 0 rows exactly. The random parts are compared by moments
(five standard errors at 2^14 rows). The two walk paths of
``chip_smoke.py`` (``random_walk_tracking``, ``gaussian_walk_drift``) run
at N = 4096 through both packages from one initial cloud; both must pass
the path's gate and agree by moments.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
from qinfer_tpu.smc import SMCConfig as JConfig
from qinfer_tpu.smc import smc_update_step as j_step
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 4096
CPU = torch.device("cpu")
ROWS = 1 << 14


@pytest.mark.parametrize("under,step,ep", [
    (qi.SimplePrecessionModel(), [0.125], {"t": np.array([1.0], np.float32)}),
    (qi.SimplePrecessionModel(), [-0.3],
     {"t": np.array([1.0, 2.0, 3.0], np.float32)}),
    (qi.rb.RandomizedBenchmarkingModel(), [0.1, -0.2, 0.05],
     {"m": np.array([1.0, 4.0], np.float32)}),
], ids=["one_exp", "three_exps", "three_params"])
def test_constant_step_timestep_is_exact(under, step, ep):
    walk_j = qi.RandomWalkModel(under, qi.ConstantDistribution(step))
    walk_t = from_reference(walk_j)
    assert isinstance(walk_t.step_distribution, qt.ConstantDistribution)
    d = under.n_modelparams
    params = np.random.default_rng(0).random((100, d)).astype(np.float32)
    got = walk_t.update_timestep(torch.from_numpy(params), ep,
                                 generator=torch.Generator())
    ref = np.asarray(walk_j.update_timestep(jnp.asarray(params), ep,
                                            key=jax.random.PRNGKey(0)))
    assert got.shape == ref.shape == (100, d, len(next(iter(ep.values()))))
    np.testing.assert_array_equal(got.numpy(), ref)


def _moments_agree(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    for stat in (lambda x: x, lambda x: (x - x.mean(0)) ** 2):
        x, y = stat(a), stat(b)
        se = np.sqrt((x.var(0) + y.var(0)) / x.shape[0])
        assert np.all(np.abs(x.mean(0) - y.mean(0)) <= 5 * se + 1e-12)


def test_random_walk_steps_match_jax_by_moments():
    walk_j = qi.RandomWalkModel(qi.rb.RandomizedBenchmarkingModel(),
                                qi.MultivariateNormalDistribution(
                                    [0.0, 0.01, 0.0],
                                    [[1e-4, 3e-5, 0.0], [3e-5, 4e-4, 0.0],
                                     [0.0, 0.0, 1e-6]]))
    ep = {"m": np.array([1.0, 8.0], np.float32)}
    params = np.zeros((ROWS, 3), np.float32)
    got = from_reference(walk_j).update_timestep(
        torch.from_numpy(params), ep, generator=torch.Generator().manual_seed(1))
    ref = np.asarray(walk_j.update_timestep(jnp.asarray(params), ep,
                                            key=jax.random.PRNGKey(1)))
    for e in range(2):
        _moments_agree(got[:, :, e].numpy(), ref[:, :, e])
    # Each experiment draws its own step.
    assert not torch.equal(got[:, :, 0], got[:, :, 1])


@pytest.mark.parametrize("diagonal", [True, False])
def test_gaussian_walk_timestep_matches_jax(diagonal):
    under = qi.rb.RandomizedBenchmarkingModel()
    g_j = qi.GaussianRandomWalkModel(under, diagonal=diagonal)
    g_t = from_reference(g_j)
    rng = np.random.default_rng(2)
    d, n_sigma = 3, (3 if diagonal else 1)
    params = np.concatenate(
        [rng.random((ROWS, d)), rng.uniform(0.0, 0.05, (ROWS, n_sigma))],
        1).astype(np.float32)
    params[:10, d:] = 0.0  # σ = 0 rows do not move
    ep = {"m": np.array([1.0, 2.0, 4.0], np.float32)}
    got = g_t.update_timestep(torch.from_numpy(params), ep,
                              generator=torch.Generator().manual_seed(3))
    ref = np.asarray(g_j.update_timestep(jnp.asarray(params), ep,
                                         key=jax.random.PRNGKey(3)))
    assert got.shape == ref.shape == (ROWS, d + n_sigma, 3)
    got = got.numpy()
    for e in range(3):
        np.testing.assert_array_equal(got[:, d:, e], params[:, d:])
        np.testing.assert_array_equal(got[:10, :d, e], params[:10, :d])
        scale = params[:, d:]  # (ROWS, 1) broadcasts when σ is shared
        z_t = (got[10:, :d, e] - params[10:, :d]) / scale[10:]
        z_j = (ref[10:, :d, e] - params[10:, :d]) / scale[10:]
        _moments_agree(z_t, z_j)
        np.testing.assert_allclose(z_t.std(0), 1.0, atol=0.05)


def test_timestep_counts_experiments_by_rows():
    """E is the expparams' leading axis in the port, for a field of k
    columns too (the JAX package's walks count E·k there, from the first
    field flattened: ROADMAP Queue C)."""
    walk = qt.RandomWalkModel(qt.MultiCosModel(n_terms=2),
                              qt.ConstantDistribution([0.5, 0.5]))
    out = walk.update_timestep(torch.zeros((4, 2)),
                               {"ts": torch.ones((3, 2))})
    assert out.shape == (4, 2, 3)
    g = qt.GaussianRandomWalkModel(qt.MultiCosModel(n_terms=2))
    assert g.update_timestep(torch.zeros((4, 4)),
                             {"ts": torch.ones((3, 2))}).shape == (4, 4, 3)


def test_timestep_follows_update_and_resample(monkeypatch):
    """In the step the walk runs last: after the update and after the
    conditional resample, as in the JAX package's step."""
    calls = []
    walk = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                              qt.ConstantDistribution([0.0]))
    resampler = qt.LiuWestResampler()
    orig_ll = qt.SimplePrecessionModel.log_likelihood
    orig_ts = qt.RandomWalkModel.update_timestep
    orig_rs = qt.LiuWestResampler.__call__

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(qt.SimplePrecessionModel, "log_likelihood",
                        spy("update", orig_ll))
    monkeypatch.setattr(qt.RandomWalkModel, "update_timestep",
                        spy("timestep", orig_ts))
    monkeypatch.setattr(qt.LiuWestResampler, "__call__",
                        spy("resample", orig_rs))
    g = torch.Generator().manual_seed(0)
    st = qt.init_smc_state(g, walk, 512, qt.UniformDistribution([0, 1]))
    qt.smc_update_step(walk, resampler, qt.SMCConfig(resample_thresh=2.0),
                       st, 1, {"t": torch.tensor([3.0])})
    assert calls == ["update", "resample", "timestep"]


def test_walk_step_matches_jax_without_resampling():
    """One step of the walk's SMC update, element for element: the update's
    weights and then every row moved by the constant step."""
    walk_j = qi.RandomWalkModel(qi.BinomialModel(qi.SimplePrecessionModel()),
                                qi.ConstantDistribution([0.01]))
    st = qi.init_smc_state(jax.random.PRNGKey(0), walk_j, 2048,
                           qi.UniformDistribution([0.0, 1.0]))
    ep = {"t": np.array([np.pi / 2], np.float32), "n_meas": np.array([40])}
    st_j, ln_j = j_step(walk_j, qi.LiuWestResampler(),
                        JConfig(resample_thresh=-1.0), st, jnp.int32(17), ep)
    st_t, ln_t = qt.smc_update_step(
        from_reference(walk_j), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0),
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st)), 17, ep)
    np.testing.assert_allclose(float(ln_t), float(ln_j), rtol=1e-5)
    # Weights, not log-weights: the 40-shot binomial log-pmf cancels
    # lgamma(41) ≈ 110 in f32, a few ulps apart in the two packages.
    np.testing.assert_allclose(np.exp(st_t.particle_log_weights.numpy()),
                               np.exp(np.asarray(st_j.particle_log_weights)),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(st_t.particle_locations.numpy(),
                                  np.asarray(st_j.particle_locations))


def test_batched_step_walks_each_trial():
    walk = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                              qt.ConstantDistribution([0.25]))
    g = torch.Generator().manual_seed(0)
    st = qt.init_batched_smc_state(g, walk, 3, 256,
                                   qt.UniformDistribution([0, 1]))
    before = st.particle_locations.clone()
    st, _ = qt.smc_update_step_batched(
        walk, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0), st,
        torch.tensor([0, 1, 0]), {"t": torch.tensor([1.0, 2.0, 3.0])})
    torch.testing.assert_close(st.particle_locations, before + 0.25,
                               rtol=0, atol=0)


def _assert_by_moments(mean_t, var_t, mean_j, var_j):
    assert np.all(np.abs(mean_t - mean_j)
                  < 5 * np.sqrt(var_t + var_j) + 1e-6), (mean_t, mean_j)
    assert np.all((0.2 < var_t / var_j) & (var_t / var_j < 5.0))


def test_random_walk_tracking_path_matches_jax():
    """chip_smoke's random_walk_tracking at N = 4096, 1000 updates, both
    packages from one cloud: both pass the path's gate (RMS of the second
    half < 0.06, final error < 6σ̂ + 0.02)."""
    walk_j = qi.RandomWalkModel(qi.BinomialModel(qi.SimplePrecessionModel()),
                                qi.NormalDistribution(0.0, 1e-4))
    ju = qi.SMCUpdater(walk_j, N, qi.UniformDistribution([0.0, 1.0]),
                       zero_weight_policy="reset", seed=0)
    tu = chip_smoke.random_walk_updater(N, 0, CPU)
    assert type(from_reference(walk_j).underlying_model) is type(
        tu.model.underlying_model)
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    w = chip_smoke.random_walk_window(tu)
    ok, values = chip_smoke.random_walk_gate(w)
    assert ok, values
    omega, counts = chip_smoke.random_walk_record()
    ep = {"t": jnp.array([chip_smoke.WALK_T], jnp.float32),
          "n_meas": jnp.array([chip_smoke.WALK_SHOTS], jnp.int32)}
    ests = []
    for k in counts:
        ju.update(jnp.int32(k), ep)
        ests.append(ju.est_mean()[0])
    var_j = float(ju.est_covariance_mtx()[0, 0])
    wj = {"est": np.asarray(jnp.stack(ests)), "truth": omega[1:],
          "sd": float(np.sqrt(var_j))}
    ok_j, values_j = chip_smoke.random_walk_gate(wj)
    assert ok_j, values_j
    assert tu.resample_count > 0 and ju.resample_count > 0
    np.testing.assert_allclose(tu.normalization_record[0],
                               ju.normalization_record[0], rtol=1e-4)
    _assert_by_moments(w["est"][-1], w["sd"] ** 2, wj["est"][-1], var_j)


def test_gaussian_walk_drift_path_matches_jax():
    """chip_smoke's gaussian_walk_drift at N = 4096, both packages from one
    cloud: both pass the path's gate (final error < 6σ̂ + 0.02, mean σ in
    [0, 0.05], a finite bank) and agree by moments."""
    g_j = qi.GaussianRandomWalkModel(qi.SimplePrecessionModel(),
                                     diagonal=True)
    ju = qi.SMCUpdater(g_j, N, qi.UniformDistribution([[0, 1], [0.001, 0.05]]),
                       zero_weight_policy="reset", seed=0)
    tu = chip_smoke.gaussian_walk_updater(N, 0, CPU)
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    w = chip_smoke.gaussian_walk_window(tu)
    ok, values = chip_smoke.gaussian_walk_gate(w)
    assert ok, values
    omega, ts, outcomes = chip_smoke.gaussian_walk_record()
    ju.batch_update(jnp.asarray(outcomes), {"t": jnp.asarray(ts)})
    cov_j = np.asarray(ju.est_covariance_mtx())
    wj = {"est": np.asarray(ju.est_mean()), "sd": np.sqrt(np.diag(cov_j)),
          "truth": omega[-1],
          "finite": bool(np.isfinite(np.asarray(
              ju.particle_locations)).all())}
    ok_j, values_j = chip_smoke.gaussian_walk_gate(wj)
    assert ok_j, values_j
    assert tu.resample_count > 0 and ju.resample_count > 0
    np.testing.assert_allclose(tu.normalization_record[0],
                               ju.normalization_record[0], rtol=1e-4)
    _assert_by_moments(w["est"], w["sd"] ** 2, wj["est"], wj["sd"] ** 2)
