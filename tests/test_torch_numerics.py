"""Port parity: weighted-particle numerics, the uniform prior and the
SimplePrecession model of qinfer_tpu_torch against qinfer_tpu on the same
seeded numpy inputs (CPU). Tolerance: rtol 1e-6 — the two packages compute
the same f32 formulas and differ only in reduction order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.utils as ju
import qinfer_tpu_torch as qt
import qinfer_tpu_torch.utils as tu

torch.set_num_threads(2)

RTOL = 1e-6


def _cloud(n, d, seed):
    rng = np.random.default_rng(seed)
    locs = (0.3 + 1e-3 * rng.standard_normal((n, d))).astype(np.float32)
    lw = np.log(rng.random(n)).astype(np.float32)
    return locs, lw


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [1, 3])
def test_weighted_numerics_match_jax(d):
    locs, lw = _cloud(5000, d, d)
    tl, tw = torch.from_numpy(locs), torch.from_numpy(lw)
    jl, jw = jnp.asarray(locs), jnp.asarray(lw)

    t_norm, t_lse = tu.normalize_log_weights(tw)
    j_norm, j_lse = ju.normalize_log_weights(jw)
    _close(t_norm, j_norm, atol=1e-6)
    _close(t_lse, j_lse)
    _close(tu.log_effective_sample_size(tw), ju.log_effective_sample_size(jw))
    _close(tu.effective_sample_size(tw), ju.effective_sample_size(jw))

    w = np.exp(np.asarray(j_norm))
    _close(tu.particle_mean(torch.from_numpy(w), tl),
           ju.particle_mean(jnp.asarray(w), jl))
    # Covariances of a cloud 1e-3 wide around 0.3: the centered form keeps
    # them positive; reduction order leaves ~1e-6 relative.
    _close(tu.particle_covariance_mtx(torch.from_numpy(w), tl),
           ju.particle_covariance_mtx(jnp.asarray(w), jl), rtol=1e-5,
           atol=1e-12)
    t_mu, t_cov = tu.weighted_moments(tw, tl)
    j_mu, j_cov = ju.weighted_moments(jw, jl)
    _close(t_mu, j_mu)
    _close(t_cov, j_cov, rtol=1e-5, atol=1e-12)
    assert np.all(np.diag(t_cov.numpy()) > 0)


@pytest.mark.parametrize("d", [1, 3])
def test_sqrtm_psd_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    a = rng.standard_normal((d, d)).astype(np.float32)
    mat = (a @ a.T + 0.1 * np.eye(d)).astype(np.float32)
    t_root, t_err = tu.sqrtm_psd(torch.from_numpy(mat), est_error=True)
    j_root, j_err = ju.sqrtm_psd(jnp.asarray(mat), est_error=True)
    # eigh in f32 on both sides: the root agrees to a few ulps of its norm.
    _close(t_root, j_root, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_root.numpy() @ t_root.numpy(), mat,
                               rtol=1e-4, atol=1e-5)
    assert float(t_err) == float(j_err) == 0.0


def test_sqrtm_psd_clips_negative_eigenvalues():
    mat = torch.tensor([[1.0, 0.0], [0.0, -0.5]])
    root, err = tu.sqrtm_psd(mat, est_error=True)
    np.testing.assert_allclose(root.numpy(), [[1.0, 0.0], [0.0, 0.0]])
    assert float(err) == pytest.approx(0.5)


def test_uniform_distribution_samples_its_box():
    prior = qt.UniformDistribution([[0.0, 1.0], [-2.0, 3.0]])
    assert prior.n_rvs == 2
    assert prior.ranges == qi.UniformDistribution(
        [[0.0, 1.0], [-2.0, 3.0]]).ranges
    g = torch.Generator().manual_seed(0)
    x = prior.sample(g, 20000)
    assert x.shape == (20000, 2) and x.dtype == torch.float32
    assert float(x[:, 0].min()) >= 0.0 and float(x[:, 0].max()) < 1.0
    assert float(x[:, 1].min()) >= -2.0 and float(x[:, 1].max()) < 3.0
    np.testing.assert_allclose(x.mean(0).numpy(), [0.5, 0.5], atol=0.05)
    assert qt.UniformDistribution([0.0, 1.0]).n_rvs == 1


def test_particle_distribution_matches_jax():
    locs, lw = _cloud(3000, 2, 5)
    t = qt.ParticleDistribution(locs, log_weights=lw)
    j = qi.ParticleDistribution(locs, log_weights=lw)
    assert t.n_rvs == j.n_rvs and t.n_particles == j.n_particles
    _close(t.particle_weights, j.particle_weights, rtol=1e-5)
    # The weights come through a logsumexp on each side: an ulp of the
    # normalizer scales every weight alike, ~1e-6 relative on the mean.
    _close(t.est_mean(), j.est_mean(), rtol=1e-5)
    _close(t.est_covariance_mtx(), j.est_covariance_mtx(), rtol=1e-5,
           atol=1e-12)
    _close(t.est_covariance_mtx(corr=True), j.est_covariance_mtx(corr=True),
           rtol=1e-5, atol=1e-6)
    _close(t.n_ess, j.n_ess, rtol=1e-5)
    s = t.sample(torch.Generator().manual_seed(1), 7)
    assert s.shape == (7, 2)
    uniform = qt.ParticleDistribution(locs)
    assert float(uniform.n_ess) == pytest.approx(3000, rel=1e-4)


@pytest.mark.parametrize("min_freq", [0.0, 0.4])
def test_precession_model_matches_jax(min_freq):
    rng = np.random.default_rng(3)
    params = rng.random((257, 1)).astype(np.float32)
    ts = np.array([0.5, 3.0, 17.3, 1e4], np.float32)
    tm = qt.SimplePrecessionModel(min_freq=min_freq)
    jm = qi.SimplePrecessionModel(min_freq=min_freq)
    tp, jp = torch.from_numpy(params), jnp.asarray(params)
    ep_t, ep_j = {"t": torch.from_numpy(ts)}, {"t": jnp.asarray(ts)}
    assert tm.n_modelparams == jm.n_modelparams == 1
    assert tm.modelparam_names == jm.modelparam_names
    assert tm.expparams_dtype == jm.expparams_dtype
    assert tm.n_outcomes() == 2
    _close(tm.pr0(tp, ep_t), jm.pr0(jp, ep_j), rtol=1e-5, atol=1e-6)
    out_t = torch.tensor([0, 1])
    ll_t = tm.log_likelihood(out_t, tp, ep_t).numpy()
    ll_j = np.asarray(jm.log_likelihood(jnp.array([0, 1]), jp, ep_j))
    assert ll_t.shape == ll_j.shape == (2, 257, 4)
    # Compare on the weight scale: log1p(−pr0) near pr0 → 1 amplifies an
    # ulp of cos into O(1) in log space (CLAUDE.md).
    np.testing.assert_allclose(np.exp(ll_t), np.exp(ll_j), atol=1e-5)
    _close(tm.likelihood(out_t, tp, ep_t),
           jm.likelihood(jnp.array([0, 1]), jp, ep_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.are_models_valid(tp).numpy(),
                                  np.asarray(jm.are_models_valid(jp)))
    neg = np.array([[-0.2], [0.1], [0.9]], np.float32)
    _close(tm.canonicalize(torch.from_numpy(neg)),
           jm.canonicalize(jnp.asarray(neg)))


def test_log_pr0_to_log_likelihood_clip_and_log1p():
    pr0 = np.array([[0.0], [1e-3], [0.5], [1.0]], np.float32)
    t = qt.FiniteOutcomeModel.log_pr0_to_log_likelihood(
        torch.tensor([0, 1]), torch.from_numpy(pr0)).numpy()
    j = np.asarray(qi.FiniteOutcomeModel.log_pr0_to_log_likelihood(
        jnp.array([0, 1]), jnp.asarray(pr0)))
    # pr0 = 1 gives log1p(−1) = −inf for outcome 1 in both packages
    # (1 − 1e-35 rounds to 1 in f32); the engine's −87 floor follows.
    np.testing.assert_allclose(t, j, rtol=RTOL)
    assert np.isneginf(t[1, 3, 0]) and np.all(np.isfinite(t[:, :3]))


def test_update_timestep_default_is_identity():
    params = torch.rand(11, 1, generator=torch.Generator().manual_seed(0))
    out = qt.SimplePrecessionModel().update_timestep(
        params, {"t": torch.tensor([1.0, 2.0])})
    assert out.shape == (11, 1, 2)
    np.testing.assert_array_equal(out[:, :, 1].numpy(), params.numpy())


def test_fused_support_gate_blocks_likelihood_override():
    """Mirror of the JAX gate test: a subclass that changes the likelihood
    without a fused spec of its own must not be routed to the ancestor's."""

    @dataclasses.dataclass(frozen=True, eq=False)
    class TweakedPrecession(qt.SimplePrecessionModel):
        def pr0(self, modelparams, expparams):
            return 0.5 * super().pr0(modelparams, expparams)

    @dataclasses.dataclass(frozen=True, eq=False)
    class RenamedPrecession(qt.SimplePrecessionModel):
        pass

    assert qt.SimplePrecessionModel().fused_update_supported
    assert not TweakedPrecession().fused_update_supported
    assert RenamedPrecession().fused_update_supported
    assert not qt.FiniteOutcomeModel().fused_update_supported
