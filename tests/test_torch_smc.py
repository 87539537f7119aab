"""Port parity for the SMC core and the whole slice (CPU).

One ``smc_update_step`` without resampling is compared element-wise with
the JAX engine on the same state (carried across with ``interop``); with a
forced resample it is compared by moments. ``SMCUpdater.batch_update`` over
bench.py's 100-experiment record at N = 4096 is held against the JAX
``SMCUpdater`` and the f64 oracle within Monte-Carlo error, with the
bench's accuracy gate. Also here: interop round trips and the rule that
the port never imports jax.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import OraclePrecession, OracleSMC
from test_torch_fused_update import _pr64, assert_log_weights_close

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.smc import SMCConfig as JConfig
from qinfer_tpu.smc import smc_update_step as j_step
from qinfer_tpu_torch.interop import (
    from_reference,
    state_from_numpy,
    state_to_numpy,
)

torch.set_num_threads(2)

TRUE_OMEGA = 0.70710678
PORT = Path(__file__).resolve().parent.parent / "qinfer_tpu_torch"


def bench_record(n_exp, seed):
    """bench.py's _experiment_record."""
    rng = np.random.default_rng(seed)
    ts = np.minimum((9 / 8) ** np.arange(n_exp), 1e4).astype(np.float32)
    p0 = np.cos(0.5 * TRUE_OMEGA * ts) ** 2
    return ts, (rng.random(n_exp) >= p0).astype(np.int32)


def _jax_state(n, seed, prior=None):
    prior = prior or qi.UniformDistribution([0.0, 1.0])
    st = qi.init_smc_state(jax.random.PRNGKey(seed), qi.SimplePrecessionModel(),
                           n, prior)
    return st, jax.tree_util.tree_map(np.asarray, st)


def test_init_smc_state():
    g = torch.Generator().manual_seed(0)
    st = qt.init_smc_state(g, qt.SimplePrecessionModel(), 1000,
                           qt.UniformDistribution([0.0, 1.0]))
    assert st.particle_locations.shape == (1000, 1)
    assert st.particle_log_weights.dtype == torch.float32
    np.testing.assert_allclose(torch.logsumexp(st.particle_log_weights, 0),
                               0.0, atol=1e-5)
    assert int(st.n_resamples) == 0 and not bool(st.just_resampled)
    assert float(st.min_n_ess) == 1000.0 and st.generator is g


@pytest.mark.parametrize("outcome,t", [(0, 0.7), (1, 3.0), (1, 40.0)])
def test_update_step_without_resample_matches_jax(outcome, t):
    """Unfused path on both sides (log1p form): element-wise, with the
    log-weight tolerance of test_torch_fused_update (atol 1e-4 above
    max − 20 plus the cos-conditioning term)."""
    st_j, st_np = _jax_state(2048, 7)
    cfg = dict(zero_weight_policy="reset", use_fused_update=False,
               resample_thresh=-1.0)
    ep = np.array([t], np.float32)
    st_j2, ln_j = j_step(qi.SimplePrecessionModel(), qi.LiuWestResampler(),
                         JConfig(**cfg), st_j, jnp.int32(outcome),
                         {"t": jnp.asarray(ep)})
    st_t2, ln_t = qt.smc_update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(), qt.SMCConfig(**cfg),
        state_from_numpy(st_np), outcome, {"t": torch.from_numpy(ep)})
    assert_log_weights_close(
        st_t2.particle_log_weights.numpy(), st_j2.particle_log_weights,
        _pr64(st_np.particle_locations[:, 0], t, outcome))
    np.testing.assert_allclose(float(ln_t), float(ln_j), atol=1e-5)
    np.testing.assert_allclose(float(st_t2.min_n_ess), float(st_j2.min_n_ess),
                               rtol=1e-3)
    np.testing.assert_allclose(float(st_t2.log_total_likelihood),
                               float(st_j2.log_total_likelihood), atol=1e-5)
    assert not bool(st_t2.just_resampled)
    np.testing.assert_array_equal(st_t2.particle_locations.numpy(),
                                  st_np.particle_locations)


def _weighted_moments(locs, lw):
    w = np.exp(lw.astype(np.float64))
    w /= w.sum()
    mu = w @ locs[:, 0]
    return mu, w @ (locs[:, 0] - mu) ** 2


def test_forced_resample_matches_jax_by_moments():
    n = 20_000
    st_j, st_np = _jax_state(n, 3)
    ep = {"t": np.array([4.0], np.float32)}
    cfg = dict(zero_weight_policy="reset", resample_thresh=2.0)
    st_j2, _ = j_step(qi.SimplePrecessionModel(), qi.LiuWestResampler(),
                      JConfig(**cfg), st_j, jnp.int32(1),
                      {"t": jnp.asarray(ep["t"])})
    st_t2, _ = qt.smc_update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(), qt.SMCConfig(**cfg),
        state_from_numpy(st_np), 1, {"t": torch.from_numpy(ep["t"])})
    assert int(st_t2.n_resamples) == 1 and bool(st_t2.just_resampled)
    np.testing.assert_allclose(st_t2.particle_log_weights.numpy(),
                               -np.log(n), rtol=1e-6)
    # The posterior before the resample, from the unresampled update.
    st_x, _ = qt.smc_update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(),
        qt.SMCConfig(zero_weight_policy="reset", resample_thresh=-1.0),
        state_from_numpy(st_np), 1, {"t": torch.from_numpy(ep["t"])})
    mu, var = _weighted_moments(st_x.particle_locations.numpy(),
                                st_x.particle_log_weights.numpy())
    se = np.sqrt(var / n)
    for locs in (st_t2.particle_locations.numpy(),
                 np.asarray(st_j2.particle_locations)):
        assert abs(locs.mean() - mu) < 5 * se
        np.testing.assert_allclose(locs.var(), var, rtol=0.05)
        assert np.all(locs >= 0.0)


def test_time_dependent_hook_runs_after_update():
    @dataclasses.dataclass(frozen=True, eq=False)
    class Drifting(qt.SimplePrecessionModel):
        def update_timestep(self, modelparams, expparams, generator=None):
            return (modelparams + 0.25)[:, :, None]

    _, st_np = _jax_state(512, 1)
    st, _ = qt.smc_update_step(
        Drifting(), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0), state_from_numpy(st_np), 0,
        {"t": torch.tensor([1.0])})
    np.testing.assert_allclose(st.particle_locations.numpy(),
                               st_np.particle_locations + 0.25, rtol=1e-6)


@pytest.fixture(scope="module")
def slice_runs():
    """Port, JAX and f64-oracle posteriors over bench.py's record."""
    n = 4096
    ts, outcomes = bench_record(100, 0)
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), n,
                       qi.UniformDistribution([0.0, 1.0]),
                       zero_weight_policy="reset", seed=0)
    j_state0 = jax.tree_util.tree_map(np.asarray, ju.state)
    ju.batch_update(outcomes, {"t": ts})
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                       qt.UniformDistribution([0.0, 1.0]),
                       zero_weight_policy="reset", seed=0, device="cpu")
    tu.state = state_from_numpy(j_state0)  # same initial cloud
    tu.batch_update(outcomes, {"t": ts})
    rng = np.random.default_rng(0)
    oracle = OracleSMC(OraclePrecession(), n, lambda k: rng.random((k, 1)),
                       rng)
    for o, t in zip(outcomes, ts):
        oracle.update(int(o), float(t))
    return ju, tu, oracle


def test_slice_passes_the_bench_gate(slice_runs):
    _, tu, _ = slice_runs
    est = float(tu.est_mean()[0])
    assert abs(est - TRUE_OMEGA) < 0.05
    assert tu.resample_count > 0
    assert len(tu.data_record) == len(tu.normalization_record) == 100
    assert np.all(np.isfinite(tu.particle_locations.numpy()))


def test_slice_matches_jax_and_oracle(slice_runs):
    """Within Monte-Carlo error: the three runs share no random stream
    after the first resample, so each mean is compared with a bound of
    five joint posterior standard deviations plus the f32 resolution."""
    ju, tu, oracle = slice_runs
    est_t = float(tu.est_mean()[0])
    var_t = float(tu.est_covariance_mtx()[0, 0])
    for est, var in ((float(ju.est_mean()[0]),
                      float(ju.est_covariance_mtx()[0, 0])),
                     (float(oracle.est_mean()[0]),
                      float(oracle.est_cov()[0, 0]))):
        assert abs(est_t - est) < 5 * np.sqrt(var_t + var) + 1e-6
        assert 0.2 < var_t / var < 5.0
    assert abs(tu.resample_count - ju.resample_count) <= 5


def test_slice_records_match_jax_before_the_first_resample(slice_runs):
    """Same initial cloud: the evidence of each update agrees until the
    first resample draws from different streams."""
    ju, tu, _ = slice_runs
    np.testing.assert_allclose(tu.normalization_record[:5],
                               ju.normalization_record[:5], rtol=1e-5)
    assert tu.data_record[3][1]["t"] == pytest.approx(
        float(ju.data_record[3][1]["t"]))
    assert int(tu.data_record[3][0]) == int(ju.data_record[3][0])


def test_updater_update_matches_jax():
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), 1024,
                       qi.UniformDistribution([0.0, 1.0]), seed=2)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 1024,
                       qt.UniformDistribution([0.0, 1.0]), seed=2,
                       device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    for o, t in ((1, 0.5), (0, 1.5), (1, 2.5)):
        ju.update(o, {"t": np.float32(t)}, check_for_resample=False)
        tu.update(o, {"t": np.float32(t)}, check_for_resample=False)
    np.testing.assert_allclose(tu.normalization_record,
                               ju.normalization_record, rtol=1e-5)
    np.testing.assert_allclose(tu.est_mean().numpy(),
                               np.asarray(ju.est_mean()), rtol=1e-5)
    np.testing.assert_allclose(tu.est_covariance_mtx().numpy(),
                               np.asarray(ju.est_covariance_mtx()), rtol=1e-4)
    np.testing.assert_allclose(float(tu.n_ess), float(ju.n_ess), rtol=1e-4)
    np.testing.assert_allclose(tu.log_total_likelihood,
                               ju.log_total_likelihood, atol=1e-5)
    np.testing.assert_allclose(tu.total_likelihood, ju.total_likelihood,
                               rtol=1e-4)
    np.testing.assert_allclose(tu.min_n_ess, ju.min_n_ess, rtol=1e-4)
    assert tu.resample_count == 0 and not tu.just_resampled
    assert tu.n_particles == 1024 and tu.data_record_array.shape[0] == 3
    np.testing.assert_allclose(tu.est_covariance_mtx(corr=True).numpy(), 1.0)
    tu.resample()
    assert tu.resample_count == 1 and tu.just_resampled


def test_zero_weight_policies():
    # t = 0 makes outcome 1 impossible: the evidence collapses.
    def run(policy):
        u = qt.SMCUpdater(qt.SimplePrecessionModel(), 256,
                          qt.UniformDistribution([0.0, 1.0]),
                          zero_weight_policy=policy, device="cpu")
        u.update(1, {"t": np.float32(0.0)})
        return u

    with pytest.raises(RuntimeError, match="total weight"):
        run("error")
    with pytest.warns(qt.ApproximationWarning):
        run("warn")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        u = run("reset")
        run("ignore")
    np.testing.assert_allclose(u.particle_log_weights.numpy(),
                               -np.log(256.0), rtol=1e-6)
    with pytest.raises(ValueError, match="zero_weight_policy"):
        qt.SMCUpdater(qt.SimplePrecessionModel(), 8,
                      qt.UniformDistribution([0.0, 1.0]),
                      zero_weight_policy="bogus", device="cpu")


def test_interop_state_round_trip():
    st_j, st_np = _jax_state(300, 4)
    st = state_from_numpy(st_np)
    back = state_to_numpy(st)
    for name, value in back.items():
        np.testing.assert_array_equal(value, np.asarray(getattr(st_np, name)))
        assert value.dtype == np.asarray(getattr(st_np, name)).dtype
    again = state_to_numpy(state_from_numpy(back))
    for name in back:
        np.testing.assert_array_equal(again[name], back[name])
    assert isinstance(st.generator, torch.Generator)


def test_interop_static_objects():
    m = from_reference(qi.SimplePrecessionModel(min_freq=0.2))
    assert isinstance(m, qt.SimplePrecessionModel) and m.min_freq == 0.2
    p = from_reference(qi.UniformDistribution([[0.0, 1.0], [2.0, 3.0]]))
    assert p.ranges == ((0.0, 1.0), (2.0, 3.0))
    r = from_reference(qi.LiuWestResampler(a=0.9, h=0.3, maxiter=5,
                                           zero_cov_comp=1e-3,
                                           postselect=False,
                                           use_systematic=False))
    assert (r.a, r.h, r.maxiter, r.zero_cov_comp, r.postselect,
            r.use_systematic) == (0.9, 0.3, 5, 1e-3, False, False)
    c = from_reference(JConfig(resample_thresh=0.3, zero_weight_policy="warn",
                               zero_weight_thresh=1e-8, canonicalize=False,
                               use_fused_update=True))
    assert c == qt.SMCConfig(0.3, "warn", 1e-8, True)
    with pytest.raises(ValueError, match="noise kernel"):
        from_reference(qi.LiuWestResampler(kernel=lambda k, s: None))
    cr = from_reference(qi.ClusteringResampler(
        eps=0.2, secondary_resampler=qi.LiuWestResampler(a=0.9)))
    assert isinstance(cr, qt.ClusteringResampler) and cr.host_side
    assert (cr.eps, cr.min_particles, cr.secondary_resampler.a) == (0.2, 5, 0.9)
    with pytest.raises(TypeError, match="no port counterpart"):
        from_reference(object())


@pytest.mark.parametrize("obj,fields", [
    (qi.SimpleInversionModel(min_freq=0.1), {"min_freq": 0.1}),
    (qi.CoinModel(), {}),
    (qi.NoisyCoinModel(), {}),
    (qi.MultiCosModel(n_terms=3), {"n_terms": 3}),
    (qi.KnownT2PrecessionModel(t2=30.0, min_freq=0.2),
     {"t2": 30.0, "min_freq": 0.2}),
    (qi.rb.RandomizedBenchmarkingModel(interleaved=True),
     {"interleaved": True}),
    (qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel()), {}),
    (qi.DifferentiableBinomialModel(qi.KnownT2PrecessionModel(t2=5.0)), {}),
], ids=lambda v: type(v).__name__ if not isinstance(v, dict) else "")
def test_interop_zoo_models(obj, fields):
    m = from_reference(obj)
    assert type(m).__name__ == type(obj).__name__
    assert type(m).__module__.startswith("qinfer_tpu_torch.")
    for name, value in fields.items():
        assert getattr(m, name) == value
    if isinstance(obj, qi.BinomialModel):  # the chain converts recursively
        under = m.underlying_model
        assert type(under).__name__ == type(obj.underlying_model).__name__
        assert type(under).__module__.startswith("qinfer_tpu_torch.")
        assert vars(under) == {k: v for k, v in vars(obj.underlying_model)
                               .items() if not k.startswith("_")}


def test_port_never_imports_jax():
    code = ("import sys, qinfer_tpu_torch, qinfer_tpu_torch.interop, "
            "qinfer_tpu_torch.ops; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PORT.parent, timeout=120)
    for src in PORT.rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
