"""The rest of the model zoo against the JAX package (CPU): ``NDieModel``,
``MultinomialModel`` with vector outcomes through the SMC step,
``MLEModel``, ``ReferencedPoissonModel`` and the likelihoods of the
random walks (their timesteps are in ``test_torch_timedep.py``).

Each model is built with ``interop.from_reference`` from the JAX one.
Likelihoods, validity, canonicalization and the design functions
(``bayes_risk``, ``expected_information_gain``) take the same NumPy inputs
through both packages and agree at rtol 1e-5 (likelihoods: atol 1e-6);
``simulate_experiment`` is held by moments (five standard errors at
2^14 draws). The ``multinomial_die`` path of ``chip_smoke.py`` runs at
N = 4096 through both packages from one initial cloud.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.distributions as jd
import qinfer_tpu.domains as jdom
import qinfer_tpu.models as jm
import qinfer_tpu_torch as qt
from qinfer_tpu.smc import SMCConfig as JConfig
from qinfer_tpu.smc import smc_update_step as j_step
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 4096
CPU = torch.device("cpu")


def _die_params(n, k, seed):
    return np.random.default_rng(seed).dirichlet(np.ones(k), n).astype(
        np.float32)


def _walk_params(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(n), rng.uniform(0.0, 0.05, n)],
                    1).astype(np.float32)


def _poisson_params(n, seed):
    rng = np.random.default_rng(seed)
    beta = rng.uniform(0.0, 5.0, n)
    return np.stack([rng.random(n), beta + rng.uniform(0.0, 20.0, n), beta],
                    1).astype(np.float32)


# (id, JAX model, parameters (N, D), expparams, outcomes)
LIKELIHOOD_CASES = [
    ("ndie", qi.NDieModel(n=4), _die_params(50, 4, 0),
     {"exp_num": np.arange(3, dtype=np.int32)}, np.arange(4)),
    ("multinomial_die", qi.MultinomialModel(qi.NDieModel(n=3)),
     _die_params(50, 3, 1),
     {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([20, 20])},
     jdom.MultinomialDomain(20, 3).values),
    ("multinomial_binomial", qi.MultinomialModel(qi.CoinModel()),
     np.random.default_rng(2).random((40, 1)).astype(np.float32),
     {"dummy": np.zeros(3, np.float32), "n_meas": np.array([7, 7, 7])},
     jdom.MultinomialDomain(7, 2).values),
    ("random_walk", qi.RandomWalkModel(qi.SimplePrecessionModel(),
                                       qi.NormalDistribution(0.0, 1e-4)),
     np.random.default_rng(3).random((60, 1)).astype(np.float32),
     {"t": np.array([np.pi / 2, 3.0], np.float32)}, np.array([0, 1])),
    ("gaussian_walk", qi.GaussianRandomWalkModel(qi.SimplePrecessionModel()),
     _walk_params(60, 4), {"t": np.array([1.0, 9.0], np.float32)},
     np.array([0, 1])),
    ("gaussian_walk_shared",
     qi.GaussianRandomWalkModel(qi.MultiCosModel(n_terms=2), diagonal=False),
     np.random.default_rng(5).random((60, 3)).astype(np.float32),
     {"ts": np.array([[1.0, 2.0], [3.0, 0.5]], np.float32)},
     np.array([0, 1])),
    ("mle", qi.MLEModel(qi.CoinModel(), likelihood_power=4.0),
     np.random.default_rng(6).random((60, 1)).astype(np.float32),
     {"dummy": np.zeros(1, np.float32)}, np.array([0, 1])),
    ("referenced_poisson", qi.ReferencedPoissonModel(
        qi.SimplePrecessionModel(), max_rate=25.0), _poisson_params(60, 7),
     {"t": np.array([1.0, 2.0, 3.0], np.float32),
      "mode": np.array([0, 1, 2])}, np.arange(60)),
]


@pytest.mark.parametrize("case", LIKELIHOOD_CASES, ids=lambda c: c[0])
def test_likelihood_matches_jax(case):
    _, model_j, params, ep, outcomes = case
    model_t = from_reference(model_j)
    outcomes = np.array(outcomes)
    got = model_t.log_likelihood(torch.from_numpy(outcomes),
                                 torch.from_numpy(params), ep)
    ref = np.asarray(model_j.log_likelihood(jnp.asarray(outcomes),
                                            jnp.asarray(params), ep))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        model_t.likelihood(torch.from_numpy(outcomes),
                           torch.from_numpy(params), ep).numpy(),
        np.asarray(model_j.likelihood(jnp.asarray(outcomes),
                                      jnp.asarray(params), ep)),
        rtol=1e-5, atol=1e-6)
    valid = model_t.are_models_valid(torch.from_numpy(params))
    np.testing.assert_array_equal(
        valid.numpy(), np.asarray(model_j.are_models_valid(params)))
    bad = params - 0.3
    np.testing.assert_allclose(
        model_t.canonicalize(torch.from_numpy(bad)).numpy(),
        np.asarray(model_j.canonicalize(jnp.asarray(bad))), rtol=1e-6,
        atol=1e-7)
    assert model_t.n_modelparams == model_j.n_modelparams
    assert tuple(model_t.modelparam_names) == tuple(model_j.modelparam_names)
    assert model_t.expparams_dtype == model_j.expparams_dtype
    # No B1 tile: the step updates every one of these models unfused.
    assert not getattr(model_t, "fused_update_supported", False)


def test_random_walk_likelihood_is_the_underlying_models():
    """The walk delegates: over the binomial precession model (the
    random_walk_tracking path) its likelihood is BinomialModel's, bit for
    bit; BinomialModel itself is held against the JAX package in
    test_torch_models.py."""
    under = qt.BinomialModel(qt.SimplePrecessionModel())
    walk = qt.RandomWalkModel(under, qt.NormalDistribution(0.0, 1e-4))
    params = torch.rand((60, 1), generator=torch.Generator().manual_seed(0))
    ep = {"t": np.array([np.pi / 2, 3.0], np.float32),
          "n_meas": np.array([40, 40])}
    outcomes = torch.arange(41)
    torch.testing.assert_close(walk.log_likelihood(outcomes, params, ep),
                               under.log_likelihood(outcomes, params, ep),
                               rtol=0, atol=0)
    assert walk.n_outcomes(ep) == 41
    assert not getattr(walk, "fused_update_supported", False)


def _check_moments(got, ref, vector=False):
    """Means and (co)variances over the draws (axis 0) within five joint
    standard errors; with ``vector``, covariances across the trailing
    outcome axis too."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    n = got.shape[0]

    def second(a):
        c = a - a.mean(0)
        return c[..., :, None] * c[..., None, :] if vector else c * c

    for stat in (lambda a: a, second):
        a, b = stat(got), stat(ref)
        se = np.sqrt((a.var(0) + b.var(0)) / n)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 5 * se + 1e-9)


SIM_CASES = [
    ("ndie", qi.NDieModel(n=4), np.array([[0.1, 0.2, 0.3, 0.4],
                                          [0.7, 0.0, 0.2, 0.1]], np.float32),
     {"exp_num": np.zeros(2, np.int32)}),
    ("multinomial_die", qi.MultinomialModel(qi.NDieModel(n=3)),
     np.array([[0.6, 0.3, 0.1], [0.2, 0.2, 0.6]], np.float32),
     {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([20, 5])}),
    ("random_walk", qi.RandomWalkModel(
        qi.BinomialModel(qi.SimplePrecessionModel()),
        qi.NormalDistribution(0.0, 1e-4)),
     np.array([[0.3], [0.8]], np.float32),
     {"t": np.array([np.pi / 2, 2.0], np.float32),
      "n_meas": np.array([40, 40])}),
    ("gaussian_walk", qi.GaussianRandomWalkModel(qi.SimplePrecessionModel()),
     _walk_params(2, 8), {"t": np.array([1.0, 5.0], np.float32)}),
    ("mle", qi.MLEModel(qi.CoinModel(), likelihood_power=3.0),
     np.array([[0.25], [0.9]], np.float32),
     {"dummy": np.zeros(2, np.float32)}),
    ("referenced_poisson", qi.ReferencedPoissonModel(qi.CoinModel()),
     np.array([[0.5, 100.0, 10.0], [0.2, 30.0, 2.0]], np.float32),
     {"dummy": np.zeros(3, np.float32), "mode": np.array([0, 1, 2])}),
]


@pytest.mark.parametrize("case", SIM_CASES, ids=lambda c: c[0])
def test_simulate_experiment_matches_jax_by_moments(case):
    _, model_j, params, ep = case
    model_t = from_reference(model_j)
    reps = 1 << 14
    got = model_t.simulate_experiment(torch.Generator().manual_seed(0),
                                      torch.from_numpy(params), ep,
                                      repeat=reps)
    ref = np.asarray(model_j.simulate_experiment(
        jax.random.PRNGKey(0), jnp.asarray(params), ep, repeat=reps))
    assert got.dtype == torch.int32
    got = got.numpy()
    assert got.shape == ref.shape
    assert (got >= 0).all()
    if isinstance(model_j, qi.MultinomialModel):
        np.testing.assert_array_equal(
            got.sum(-1), np.broadcast_to(ep["n_meas"], got.shape[:-1]))
    if isinstance(model_j, qi.NDieModel):
        assert got.max() < model_j.n
        assert (got[:, 1] != 1).all()  # a face of probability 0
    _check_moments(got, ref, vector=isinstance(model_j, qi.MultinomialModel))


def test_sim_count_of_the_new_models():
    m = qt.MultinomialModel(qt.NDieModel(n=3))
    p = torch.tensor([[0.5, 0.25, 0.25]] * 4)
    ep = {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([3, 3])}
    m.simulate_experiment(torch.Generator(), p, ep, repeat=5)
    assert m.sim_count == 5 * 4 * 2
    rp = qt.ReferencedPoissonModel(qt.CoinModel())
    rp.simulate_experiment(torch.Generator(), torch.tensor([[0.5, 9.0, 1.0]]),
                           {"dummy": np.zeros(3, np.float32),
                            "mode": np.zeros(3, np.int64)})
    assert rp.sim_count == 3


# -- vector outcomes through the SMC step -------------------------------------------

def _die_model():
    return qi.MultinomialModel(qi.NDieModel(n=3))


def _die_prior():
    return qi.ConstrainedSumDistribution(
        qi.UniformDistribution([[0.0, 1.0]] * 3), desired_total=1.0)


def test_vector_outcome_step_matches_jax():
    """One step on a count vector, element for element (no resample)."""
    model_j = _die_model()
    st = qi.init_smc_state(jax.random.PRNGKey(0), model_j, 2048, _die_prior())
    cfg = JConfig(resample_thresh=-1.0)
    counts = np.array([12, 5, 3], np.int32)
    ep = {"exp_num": np.array([0], np.int32), "n_meas": np.array([20])}
    st_j, log_norm_j = j_step(model_j, qi.LiuWestResampler(), cfg, st,
                              jnp.asarray(counts), ep)
    st_t, log_norm_t = qt.smc_update_step(
        from_reference(model_j), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0),
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st)),
        torch.from_numpy(counts), ep)
    np.testing.assert_allclose(float(log_norm_t), float(log_norm_j),
                               rtol=1e-5)
    np.testing.assert_allclose(st_t.particle_log_weights.numpy(),
                               np.asarray(st_j.particle_log_weights),
                               rtol=1e-5, atol=1e-4)
    # The whole vector counts: the first count alone updates otherwise.
    st_first, _ = qt.smc_update_step(
        from_reference(model_j), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0),
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st)),
        torch.tensor([12, 0, 0]), ep)
    assert float((st_first.particle_log_weights
                  - st_t.particle_log_weights).abs().max()) > 1.0


def test_batch_update_takes_the_whole_count_vector():
    """A (100, 3) record through ``SMCUpdater.batch_update`` in both
    packages from one cloud, without resampling: one evidence per count
    vector, each the JAX package's, and the same posterior mean."""
    counts = chip_smoke.die_record()
    ep = {"exp_num": np.zeros(len(counts), np.int32),
          "n_meas": np.full(len(counts), chip_smoke.DIE_SHOTS, np.int32)}
    ju = qi.SMCUpdater(_die_model(), 2048, _die_prior(), resample_thresh=0.0,
                       seed=0)
    tu = qt.SMCUpdater(from_reference(_die_model()), 2048,
                       from_reference(_die_prior()), resample_thresh=0.0,
                       seed=0, device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    ju.batch_update(jnp.asarray(counts), ep)
    tu.batch_update(counts, ep)
    assert len(tu.normalization_record) == len(counts)
    np.testing.assert_allclose(tu.normalization_record,
                               ju.normalization_record, rtol=1e-4)
    np.testing.assert_allclose(tu.est_mean().numpy(),
                               np.asarray(ju.est_mean()), rtol=1e-4)
    np.testing.assert_array_equal(tu.data_record[7][0], counts[7])


def test_round2_vector_outcomes_through_the_updater():
    """tests/test_round2_fixes.py:13-45 through the port."""
    model = qt.MultinomialModel(qt.NDieModel(n=3))
    prior = from_reference(_die_prior())
    u = qt.SMCUpdater(model, 2000, prior, seed=0, device="cpu")
    true_p = np.array([0.6, 0.3, 0.1])
    rng = np.random.default_rng(0)
    ep = {"exp_num": np.array([0], np.int32), "n_meas": np.array([20])}
    for _ in range(10):
        u.update(torch.as_tensor(rng.multinomial(20, true_p),
                                 dtype=torch.int32), ep)
    np.testing.assert_allclose(u.est_mean().numpy(), true_p, atol=0.12)
    T = 6
    outcomes = torch.as_tensor(rng.multinomial(20, true_p, size=T),
                               dtype=torch.int32)
    eps = {"exp_num": np.zeros(T, np.int32), "n_meas": np.full(T, 20)}
    u2 = qt.SMCUpdater(model, 2000, prior, seed=1, device="cpu")
    u2.batch_update(outcomes, eps)
    assert len(u2.normalization_record) == T
    np.testing.assert_allclose(u2.est_mean().numpy(), true_p, atol=0.15)
    hyp = u2.hypothetical_update(outcomes[:2], {"exp_num": np.zeros(1),
                                                "n_meas": np.array([20])})
    assert hyp.shape == (2, 1, 2000)


def test_count_vectors_through_the_eager_route():
    """With divergence tracking, batch_update replays the (T, 3) record
    vector by vector through update: one evidence and one data record per
    count vector, one divergence per resample."""
    counts = chip_smoke.die_record()[:30]
    ep = {"exp_num": np.zeros(30, np.int32), "n_meas": np.full(30, 20)}
    u = qt.SMCUpdater(from_reference(_die_model()), 2048,
                      from_reference(_die_prior()), zero_weight_policy="reset",
                      track_resampling_divergence=True, seed=0, device="cpu")
    u.batch_update(counts, ep)
    assert len(u.normalization_record) == len(u.data_record) == 30
    np.testing.assert_array_equal(u.data_record[3][0], counts[3])
    assert len(u.resampling_divergences) == u.resample_count > 0
    assert np.all(np.isfinite(u.normalization_record))


def test_mle_model_sharpens_the_posterior():
    """tests/test_derived_models.py:100-113 through the port."""
    base = qt.CoinModel()
    mle = qt.MLEModel(base, likelihood_power=4.0)
    prior = qt.UniformDistribution([0.0, 1.0])
    ep = {"dummy": np.zeros(1, np.float32)}
    u1 = qt.SMCUpdater(base, 4000, prior, seed=1, device="cpu")
    u2 = qt.SMCUpdater(mle, 4000, prior, seed=1, device="cpu")
    for f in [1, 1, 0, 1, 1]:
        u1.update(f, ep)
        u2.update(f, ep)
    assert float(u2.est_covariance_mtx()[0, 0]) < float(
        u1.est_covariance_mtx()[0, 0])


@pytest.mark.parametrize("which", ["multinomial", "poisson"])
def test_design_functions_match_jax(which):
    """bayes_risk and EIG over (O, k) count vectors and over the truncated
    Poisson enumeration, on one bank (N = 1024) in both packages."""
    rng = np.random.default_rng(11)
    if which == "multinomial":
        model_j = qi.MultinomialModel(qi.NDieModel(n=3))
        locs = _die_params(1024, 3, 12)
        ep = {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([6, 6])}
    else:
        model_j = qi.ReferencedPoissonModel(qi.SimplePrecessionModel(),
                                            max_rate=25.0)
        locs = _poisson_params(1024, 13)
        ep = {"t": np.array([0.5, 2.0, 4.0], np.float32),
              "mode": np.array([0, 0, 1])}
    log_w = rng.normal(0.0, 1.0, 1024).astype(np.float32)
    log_w -= np.logaddexp.reduce(log_w.astype(np.float64)).astype(np.float32)
    ju = qi.SMCUpdater(model_j, 1024, qi.UniformDistribution([0.0, 1.0]),
                       seed=0)
    ju.state = ju.state._replace(particle_locations=jnp.asarray(locs),
                                 particle_log_weights=jnp.asarray(log_w))
    tu = qt.SMCUpdater(from_reference(model_j), 1024,
                       qt.UniformDistribution([0.0, 1.0]), seed=0,
                       device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    # The JAX ReferencedPoissonModel's Q is its underlying model's, two
    # weights short (ROADMAP Queue C): give it the port's unit Q.
    q = tu.model.Q.numpy()
    assert q.shape == (model_j.n_modelparams,)
    np.testing.assert_allclose(tu.bayes_risk(ep).numpy(),
                               np.asarray(ju.bayes_risk(ep, Q=q)), rtol=1e-5)
    np.testing.assert_allclose(tu.expected_information_gain(ep).numpy(),
                               np.asarray(ju.expected_information_gain(ep)),
                               rtol=1e-5)


def test_multinomial_die_path_matches_jax():
    """chip_smoke's multinomial_die at N = 4096, both packages from one
    cloud: both pass the path's gate, the first evidence agrees, the means
    agree within five joint posterior standard deviations."""
    ju = qi.SMCUpdater(_die_model(), N, _die_prior(),
                       zero_weight_policy="reset", seed=0)
    tu = chip_smoke.die_updater(N, 0, CPU)
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    w = chip_smoke.die_window(tu)
    ok, values = chip_smoke.die_gate(w)
    assert ok, values
    counts = chip_smoke.die_record()
    ju.batch_update(jnp.asarray(counts), {
        "exp_num": np.zeros(len(counts), np.int32),
        "n_meas": np.full(len(counts), chip_smoke.DIE_SHOTS, np.int32)})
    cov_j = np.asarray(ju.est_covariance_mtx())
    wj = {"est": np.asarray(ju.est_mean()), "sd": np.sqrt(np.diag(cov_j)),
          "n_records": len(ju.normalization_record)}
    ok_j, values_j = chip_smoke.die_gate(wj)
    assert ok_j, values_j
    assert tu.resample_count > 0 and ju.resample_count > 0
    np.testing.assert_allclose(tu.normalization_record[0],
                               ju.normalization_record[0], rtol=1e-4)
    var_t, var_j = w["sd"] ** 2, wj["sd"] ** 2
    assert np.all(np.abs(w["est"] - wj["est"])
                  < 5 * np.sqrt(var_t + var_j) + 1e-6)
    assert np.all((0.2 < var_t / var_j) & (var_t / var_j < 5.0))


# -- every model, domain and distribution has a counterpart ---------------------

_ABSTRACT = {"Distribution", "SingleSampleMixin", "Domain", "Simulatable",
             "Model", "FiniteOutcomeModel", "DifferentiableModel",
             "DerivedModel"}


@pytest.mark.parametrize("module,port", [
    (jm, qt.models), (jdom, qt.domains), (jd, qt.distributions)],
    ids=["models", "domains", "distributions"])
def test_every_exported_class_has_a_counterpart(module, port):
    for name in module.__all__:
        obj = getattr(module, name)
        assert hasattr(port, name), name
        if isinstance(obj, type) and name not in _ABSTRACT:
            assert name in qt.interop._CONVERTERS, name


@pytest.mark.parametrize("obj,fields", [
    (qi.NDieModel(n=5), {"n": 5}),
    (qi.MultinomialModel(qi.NDieModel(n=4)), {}),
    (qi.RandomWalkModel(qi.CoinModel(), qi.NormalDistribution(0.0, 0.3)), {}),
    (qi.GaussianRandomWalkModel(qi.SimplePrecessionModel(0.1),
                                diagonal=False), {"diagonal": False}),
    (qi.MLEModel(qi.CoinModel(), likelihood_power=2.5),
     {"likelihood_power": 2.5}),
    (qi.ReferencedPoissonModel(qi.CoinModel(), max_rate=40.0),
     {"max_rate": 40.0}),
    (qi.ReferencedPoissonModel(qi.CoinModel()), {"max_rate": None}),
], ids=lambda v: type(v).__name__ if not isinstance(v, dict) else "")
def test_interop_new_models(obj, fields):
    m = from_reference(obj)
    assert type(m).__name__ == type(obj).__name__
    assert type(m).__module__.startswith("qinfer_tpu_torch.")
    for name, value in fields.items():
        assert getattr(m, name) == value
    under = getattr(obj, "underlying_model", None)
    if under is not None:
        assert type(m.underlying_model).__name__ == type(under).__name__
        assert vars(m.underlying_model) == {
            k: v for k, v in vars(under).items() if not k.startswith("_")}
    if isinstance(obj, qi.RandomWalkModel):
        assert isinstance(m.step_distribution, qt.NormalDistribution)
        assert m.step_distribution.var == 0.3


# -- the four members the port lacked ---------------------------------------------

@pytest.mark.parametrize("cls", ["SimplePrecessionModel", "NDieModel",
                                 "MultinomialModel"])
def test_clear_cache_and_differentiability_match_jax(cls):
    """``Simulatable.clear_cache`` is a no-op and
    ``Model.is_model_differentiable`` is True, in both packages."""
    j = {"SimplePrecessionModel": qi.SimplePrecessionModel(),
         "NDieModel": qi.NDieModel(n=3),
         "MultinomialModel": qi.MultinomialModel(qi.NDieModel(n=3))}[cls]
    t = from_reference(j)
    assert j.clear_cache() is None and t.clear_cache() is None
    assert t.is_model_differentiable is j.is_model_differentiable is True


def test_pr0_to_likelihood_array_matches_jax():
    rng = np.random.default_rng(3)
    pr0 = rng.random((17, 4)).astype(np.float32)
    outcomes = np.array([0, 1, 0, 3], np.int32)  # any outcome ≠ 0 is "1"
    j = qi.FiniteOutcomeModel.pr0_to_likelihood_array(jnp.asarray(outcomes),
                                                      jnp.asarray(pr0))
    t = qt.FiniteOutcomeModel.pr0_to_likelihood_array(
        torch.from_numpy(outcomes), torch.from_numpy(pr0))
    assert t.shape == (4, 17, 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("j_cls,t_cls,kw", [
    (qi.SimplePrecessionModel, qt.SimplePrecessionModel, {}),
    (qi.NDieModel, qt.NDieModel, {"n": 5})], ids=["precession", "die"])
def test_score_mixin_all_outcomes_matches_jax(j_cls, t_cls, kw):
    j = type("J", (qi.ScoreMixin, j_cls), {})(**kw)
    t = type("T", (qt.ScoreMixin, t_cls), {})(**kw)
    out = t.all_outcomes()
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j.all_outcomes()))
