"""The approximate models of the port against the JAX package (CPU):
``binom_est_p``/``binom_est_error``, ``ALEApproximateModel``,
``PoisonedModel`` and ``AcceleratedPrecessionModel``, with their
``interop.from_reference`` converters.

The two packages draw from different generators, so ALE's estimates are
held to the exact likelihood within 4 standard errors (as
tests/test_derived_models.py:211 holds the JAX package's), its stopping
batch to the JAX package's at the two ends (the number of draws is read
off the estimates, (k + h)/(n + 2h)), and the poisoned noise by its
statistics; everything deterministic is compared exactly or at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy
from qinfer_tpu_torch.ops import fused_update as b1

torch.set_num_threads(2)

HEDGE = 0.509  # ALEApproximateModel.est_hedge


def test_binom_estimators_match_jax():
    n = np.array([0.0, 3.0, 16.0, 7.5], np.float32)
    N = np.array([16.0, 16.0, 16.0, 32.0], np.float32)
    for hedge in (0.0, HEDGE):
        p_t = qt.binom_est_p(torch.from_numpy(n), torch.from_numpy(N), hedge)
        p_j = np.asarray(qi.binom_est_p(jnp.asarray(n), jnp.asarray(N), hedge))
        np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-6)
        np.testing.assert_allclose(
            qt.binom_est_error(p_t, torch.from_numpy(N), hedge).numpy(),
            np.asarray(qi.binom_est_error(jnp.asarray(p_j), jnp.asarray(N),
                                          hedge)), rtol=1e-6)
    assert qt.binom_est_p(3, 10) == qi.binom_est_p(3, 10) == 0.3
    assert float(qt.binom_est_error(0.5, 16)) == pytest.approx(
        float(qi.binom_est_error(0.5, 16)), rel=1e-6)


def _coin_inputs():
    params = np.array([[0.3], [0.7], [0.05]], np.float32)
    return params, {"dummy": np.array([0.0], np.float32)}


def test_ale_within_four_standard_errors_of_the_exact_likelihood():
    """tests/test_derived_models.py:211-223 in the port, held to 4 standard
    errors of the draws it took; both packages on the same cells."""
    params, ep = _coin_inputs()
    ale_t = qt.ALEApproximateModel(simulator=qt.CoinModel(), error_tol=0.02,
                                   max_samp=4096)
    ale_j = qi.ALEApproximateModel(simulator=qi.CoinModel(), error_tol=0.02,
                                   max_samp=4096)
    outcomes = np.array([0, 1])
    L_t = ale_t.likelihood(torch.from_numpy(outcomes),
                           torch.from_numpy(params),
                           {k: torch.from_numpy(v) for k, v in ep.items()}
                           ).numpy()
    L_j = np.asarray(ale_j.likelihood(jnp.asarray(outcomes),
                                      jnp.asarray(params),
                                      {k: jnp.asarray(v) for k, v in ep.items()}))
    exact = np.asarray(qi.CoinModel().likelihood(
        jnp.asarray(outcomes), jnp.asarray(params),
        {k: jnp.asarray(v) for k, v in ep.items()}))
    assert L_t.shape == L_j.shape == (2, 3, 1)
    n = ale_t.last_n_samples
    assert 16 <= n <= 4096 and (n - 16) % 16 == 0
    se = np.sqrt(exact * (1 - exact) / n) + 1.0 / n
    assert np.all(np.abs(L_t - exact) < 4 * se)
    np.testing.assert_allclose(L_t.sum(0), 1.0, atol=0.05)
    # The same cells, the same stopping rule: JAX's estimate is as close.
    assert np.all(np.abs(L_j - exact) < 4 * se)


def _n_draws(L, hedge=HEDGE):
    """The draw count n behind hedged estimates (k + h)/(n + 2h): the
    candidate n for which every L·(n + 2h) − h is an integer."""
    for n in range(16, 4097, 16):
        k = L * (n + 2 * hedge) - hedge
        if np.all(np.abs(k - np.round(k)) < 1e-3):
            return n
    return None


@pytest.mark.parametrize("error_tol,n_expected", [(10.0, 16), (1e-6, 2048)],
                         ids=["min_samp", "max_samp"])
def test_ale_stops_at_the_same_batch_as_jax(error_tol, n_expected):
    params = np.array([[0.2], [0.55], [0.9]], np.float32)
    ep = {"t": np.array([1.7], np.float32)}
    outcomes = np.array([0, 1])
    ale_t = qt.ALEApproximateModel(qt.SimplePrecessionModel(),
                                   error_tol=error_tol)
    ale_j = qi.ALEApproximateModel(qi.SimplePrecessionModel(),
                                   error_tol=error_tol)
    L_t = ale_t.likelihood(torch.from_numpy(outcomes),
                           torch.from_numpy(params),
                           {"t": torch.from_numpy(ep["t"])}).numpy()
    L_j = np.asarray(ale_j.likelihood(jnp.asarray(outcomes),
                                      jnp.asarray(params),
                                      {"t": jnp.asarray(ep["t"])}))
    assert ale_t.last_n_samples == n_expected
    assert _n_draws(L_t.astype(np.float64)) == n_expected
    assert _n_draws(L_j.astype(np.float64)) == n_expected


def test_ale_stops_where_the_error_first_meets_the_tolerance():
    """Between the ends: the port stops at the first batch whose worst
    standard error is ≤ error_tol, and the batch before it had not."""
    params = torch.tensor([[0.02], [0.03]])  # Pr(0) ≈ 1: errors fall fast
    ep = {"t": torch.tensor([1.0])}
    ale = qt.ALEApproximateModel(qt.SimplePrecessionModel(), error_tol=0.03)
    L = ale.likelihood(torch.tensor([0, 1]), params, ep)
    n = ale.last_n_samples
    assert 16 < n < 2048
    p = L.permute(1, 2, 0)  # (N, E, O) estimates after n draws
    assert float(qt.binom_est_error(p, float(n), HEDGE).max()) <= 0.03


def test_ale_is_deterministic_and_unfused():
    params = torch.rand((64, 1), generator=torch.Generator().manual_seed(0))
    ep = {"t": torch.tensor([3.0])}
    ale = qt.ALEApproximateModel(qt.SimplePrecessionModel(), seed=5)
    a = ale.log_likelihood(torch.tensor([0, 1]), params, ep)
    b = ale.log_likelihood(torch.tensor([0, 1]), params, ep)
    assert torch.equal(a, b) and a.shape == (2, 64, 1)
    other = qt.ALEApproximateModel(qt.SimplePrecessionModel(), seed=6)
    assert not torch.equal(a, other.log_likelihood(torch.tensor([0, 1]),
                                                   params, ep))
    # Not a FiniteOutcomeModel: the engine takes the unfused update.
    assert not getattr(ale, "fused_update_supported", False)
    assert ale.n_modelparams == 1 and ale.n_outcomes(ep) == 2
    assert bool(ale.are_models_valid(params).all())


def test_poisoned_noise_is_deterministic_per_expparams():
    model = qt.PoisonedModel(qt.CoinModel(), tol=0.05)
    params = torch.rand((500, 1), generator=torch.Generator().manual_seed(1))
    ep0 = {"dummy": torch.tensor([0.0])}
    ep1 = {"dummy": torch.tensor([1.0])}
    outcomes = torch.tensor([0, 1])
    a = model.likelihood(outcomes, params, ep0)
    assert torch.equal(a, model.likelihood(outcomes, params, ep0))
    assert not torch.equal(a, model.likelihood(outcomes, params, ep1))
    assert bool(((a >= 0) & (a <= 1)).all())


@pytest.mark.parametrize("ep", [{"t": [2.0]}, {"t": [2.0, -3.5, 1e6]},
                                {"t": [7.25], "n_meas": [40]}])
def test_poisoned_noise_mix_is_the_jax_fold(ep):
    """The port's mix is the value the JAX package folds into its key."""
    mix = qt.PoisonedModel.noise_mix(
        {k: torch.as_tensor(np.asarray(v)) for k, v in ep.items()})
    model_j = qi.PoisonedModel(qi.SimplePrecessionModel(), tol=0.1, seed=3)
    key = model_j._noise_key({k: jnp.asarray(np.asarray(v))
                              for k, v in ep.items()})
    expected = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(mix))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(expected))


def test_poisoned_noise_statistics():
    """ALE mode: additive N(0, tol²) where no clip acts; MLE mode: the
    hedged binomial estimate (k + h)/(n + 2h), unbiased for hedge = 0."""
    params = torch.full((20000, 1), 0.5)
    ep = {"dummy": torch.tensor([0.0])}
    outcome = torch.tensor([0])
    L = 0.5
    ale = qt.PoisonedModel(qt.CoinModel(), tol=0.05)
    eps = ale.likelihood(outcome, params, ep).numpy() - L
    assert abs(eps.mean()) < 4 * 0.05 / np.sqrt(eps.size)
    assert eps.std() == pytest.approx(0.05, rel=0.05)
    mle = qt.PoisonedModel(qt.CoinModel(), n_samples=20, hedge=0.5)
    est = mle.likelihood(outcome, params, ep).numpy()
    k = est * (20 + 2 * 0.5) - 0.5
    np.testing.assert_allclose(k, np.round(k), atol=1e-4)
    unbiased = qt.PoisonedModel(qt.CoinModel(), n_samples=20)
    est = unbiased.likelihood(outcome, params, ep).numpy()
    assert abs(est.mean() - L) < 4 * np.sqrt(L * (1 - L) / 20 / est.size)
    assert est.var() == pytest.approx(L * (1 - L) / 20, rel=0.05)


def test_poisoned_simulator_is_not_poisoned():
    under = qt.SimplePrecessionModel()
    model = qt.PoisonedModel(under, tol=0.3)
    params = torch.rand((256, 1), generator=torch.Generator().manual_seed(2))
    ep = {"t": torch.tensor([4.0])}
    a = model.simulate_experiment(torch.Generator().manual_seed(9), params,
                                  ep, repeat=3)
    b = under.simulate_experiment(torch.Generator().manual_seed(9), params,
                                  ep, repeat=3)
    assert torch.equal(a, b) and model.sim_count == 3 * 256


def _ep(d, lib):
    return {k: (jnp.asarray(np.asarray(v)) if lib == "jax"
                else torch.as_tensor(np.asarray(v))) for k, v in d.items()}


def test_interop_accelerated_precession():
    """The converter, and the same likelihood and B1 tile as
    SimplePrecessionModel."""
    model_j = qi.AcceleratedPrecessionModel(min_freq=0.1)
    model_t = from_reference(model_j)
    assert type(model_t) is qt.AcceleratedPrecessionModel
    assert model_t.min_freq == 0.1 and model_t.fused_update_supported
    params = np.random.default_rng(3).random((300, 1)).astype(np.float32)
    ep = {"t": np.array([2.5, 9.0], np.float32)}
    outcomes = np.array([0, 1])
    np.testing.assert_allclose(
        model_t.likelihood(torch.from_numpy(outcomes),
                           torch.from_numpy(params), _ep(ep, "torch")).numpy(),
        np.asarray(model_j.likelihood(jnp.asarray(outcomes),
                                      jnp.asarray(params), _ep(ep, "jax"))),
        rtol=1e-5, atol=1e-6)  # f32 cos of two libms
    one = {"t": torch.tensor([2.5])}
    tile, scal, _ = model_t.fused_spec(1, torch.from_numpy(params), one)
    tile_s, scal_s, _ = qt.SimplePrecessionModel().fused_spec(
        1, torch.from_numpy(params), one)
    assert tile == tile_s and tile.pr1_fn is b1.precession_pr1
    assert tile.kernel_tile == tile_s.kernel_tile
    assert torch.equal(scal, scal_s)


def test_interop_ale_approximate_model():
    model_j = qi.ALEApproximateModel(qi.SimplePrecessionModel(),
                                     error_tol=0.05, min_samp=32,
                                     samp_step=8, est_hedge=0.25,
                                     max_samp=512, seed=4)
    model_t = from_reference(model_j)
    assert type(model_t) is qt.ALEApproximateModel
    assert type(model_t.simulator) is qt.SimplePrecessionModel
    for f in ("error_tol", "min_samp", "samp_step", "est_hedge", "max_samp",
              "seed"):
        assert getattr(model_t, f) == getattr(model_j, f)
    params = np.array([[0.1], [0.4], [0.8]], np.float32)
    ep = {"t": np.array([3.0], np.float32)}
    outcomes = np.array([0, 1])
    L_t = model_t.likelihood(torch.from_numpy(outcomes),
                             torch.from_numpy(params),
                             _ep(ep, "torch")).numpy()
    L_j = np.asarray(model_j.likelihood(jnp.asarray(outcomes),
                                        jnp.asarray(params), _ep(ep, "jax")))
    exact = np.asarray(qi.SimplePrecessionModel().likelihood(
        jnp.asarray(outcomes), jnp.asarray(params), _ep(ep, "jax")))
    n = model_t.last_n_samples
    se = np.sqrt(exact * (1 - exact) / n) + 1.0 / n
    assert np.all(np.abs(L_t - L_j) < 4 * np.sqrt(2) * se)


@pytest.mark.parametrize("mode", [{"tol": 0.0}, {"n_samples": 10 ** 9}],
                         ids=["ale_tol0", "mle_large_n"])
def test_interop_poisoned_model(mode):
    """The converter carries the fields; with no noise (tol = 0) or a
    vanishing one (10⁹ samples) one likelihood call agrees with JAX's."""
    model_j = qi.PoisonedModel(qi.KnownT2PrecessionModel(t2=50.0), hedge=0.0,
                               seed=7, **mode)
    model_t = from_reference(model_j)
    assert type(model_t) is qt.PoisonedModel
    assert type(model_t.underlying_model) is qt.KnownT2PrecessionModel
    assert model_t.underlying_model.t2 == 50.0
    for f in ("tol", "n_samples", "hedge", "seed"):
        assert getattr(model_t, f) == getattr(model_j, f)
    params = np.random.default_rng(5).random((200, 1)).astype(np.float32)
    ep = {"t": np.array([6.0], np.float32)}
    outcomes = np.array([0, 1])
    np.testing.assert_allclose(
        model_t.likelihood(torch.from_numpy(outcomes),
                           torch.from_numpy(params), _ep(ep, "torch")).numpy(),
        np.asarray(model_j.likelihood(jnp.asarray(outcomes),
                                      jnp.asarray(params), _ep(ep, "jax"))),
        rtol=0, atol=1e-3 if "n_samples" in mode else 1e-6)


def test_mixed_updater_switches_at_the_same_update_as_jax():
    """``AcceleratedPrecessionModel`` as the approximate model keeps the ESS
    path deterministic: from the same bank both packages switch to the
    good model at the same update."""
    good_j, approx_j = qi.SimplePrecessionModel(), qi.AcceleratedPrecessionModel()
    ju = qi.MixedApproximateSMCUpdater(good_j, approx_j, 2000,
                                       qi.UniformDistribution([0, 1]),
                                       mixture_thresh=0.9, seed=0)
    tu = qt.MixedApproximateSMCUpdater(
        from_reference(good_j), from_reference(approx_j), 2000,
        qt.UniformDistribution([0, 1]), mixture_thresh=0.9, seed=0,
        device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    rng = np.random.default_rng(0)
    switch = {"jax": None, "torch": None}
    for k in range(30):
        t = np.float32((9 / 8) ** k)
        o = int(rng.random() >= np.cos(0.5 * 0.5 * t) ** 2)
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
        tu.update(o, {"t": np.array([t])})
        for name, u in (("jax", ju), ("torch", tu)):
            if switch[name] is None and u._sharpened:
                switch[name] = k
        assert (tu.model is tu.good_model) == (ju.model is ju.good_model)
    assert switch["torch"] == switch["jax"] is not None
    assert abs(float(tu.est_mean()[0]) - 0.5) < 0.1
