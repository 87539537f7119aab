"""Port parity for the experiment-design half of the engine (CPU).

``hypothetical_log_update``, ``bayes_risk_fn`` and
``expected_information_gain_fn`` of both packages run on one state, made
with numpy from a seed and carried across with ``interop.state_from_numpy``:
rtol 1e-4, atol 1e-6. The cases cover both routes — the streaming
two-outcome route (tomography, diffusive tomography, precession) and the
general (O, N, E) route (``BinomialModel``, which overrides
``log_likelihood``) — and record-array expparams through ``SMCUpdater``.
Also here: ``hypothetical_update``, ``reset``, ``est_meanfn``,
``est_entropy``, and the device contract of ``all_outcomes`` and ``Q``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.tomography as jt
import qinfer_tpu_torch as qt
from qinfer_tpu import smc as jsmc
from qinfer_tpu_torch import smc as tsmc
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
N = 512


def _ginibre_coords(basis, n, rng, rank=None):
    d = basis.dim
    g = (rng.standard_normal((n, d, rank or d))
         + 1j * rng.standard_normal((n, d, rank or d)))
    rho = g @ g.conj().transpose(0, 2, 1)
    rho = rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]
    return np.array(basis.state_to_modelparams(rho.astype(np.complex64)))


def _case(name):
    """(JAX model, locations, candidate expparams) as numpy."""
    rng = np.random.default_rng(len(name))
    if name in ("tomography", "binomial_tomography_2q", "diffusive"):
        basis = jt.pauli_basis(2 if name.endswith("2q") else 1)
        locs = _ginibre_coords(basis, N, rng)
        meas = _ginibre_coords(basis, 3, rng, rank=1)
        if name == "tomography":
            return jt.TomographyModel(basis), locs, {"meas": meas}
        if name == "diffusive":
            eps = 0.05 * rng.random((N, 1))
            return (jt.DiffusiveTomographyModel(basis),
                    np.concatenate([locs, eps], 1),
                    {"meas": meas, "t": np.ones(3, np.float32)})
        return (qi.BinomialModel(jt.TomographyModel(basis)), locs,
                {"meas": meas, "n_meas": np.array([20, 20, 20], np.int32)})
    locs = rng.random((N, 1))
    ts = np.array([0.5, 2.0, 7.3, 20.0], np.float32)
    if name == "precession":
        return qi.SimplePrecessionModel(), locs, {"t": ts}
    return (qi.BinomialModel(qi.SimplePrecessionModel()), locs,
            {"t": ts, "n_meas": np.array([10, 10, 10, 10], np.int32)})


STREAMING = ["tomography", "diffusive", "precession"]
GENERAL = ["binomial_tomography_2q", "binomial_precession"]


def _states(locs, seed):
    """The same state in both packages: the locations and non-uniform
    normalized log-weights."""
    rng = np.random.default_rng(seed)
    lw = np.log(rng.random(len(locs)) ** 2 + 1e-3)
    lw = (lw - np.log(np.sum(np.exp(lw)))).astype(np.float32)
    locs = locs.astype(np.float32)
    st_j = qi.init_smc_state(jax.random.PRNGKey(0), qi.SimplePrecessionModel(),
                             len(locs), qi.UniformDistribution([0.0, 1.0]))
    st_j = st_j._replace(particle_locations=jnp.asarray(locs),
                         particle_log_weights=jnp.asarray(lw))
    st_t = state_from_numpy(jax.tree_util.tree_map(np.asarray, st_j))
    return st_j, st_t


def _both(name):
    model_j, locs, ep = _case(name)
    st_j, st_t = _states(locs, 1)
    ep_j = {k: jnp.asarray(v) for k, v in ep.items()}
    ep_t = {k: torch.tensor(np.asarray(v)) for k, v in ep.items()}
    return (model_j, from_reference(model_j), st_j, st_t, ep_j, ep_t)


@pytest.mark.parametrize("name", STREAMING + GENERAL)
def test_route_matches_jax(name):
    """The streaming route is taken exactly where the JAX package takes it."""
    mj, mt, st_j, st_t, ep_j, ep_t = _both(name)
    pr1_j = jsmc._streaming_pr1(mj, st_j, ep_j, mj.all_outcomes(ep_j))
    pr1_t = tsmc._streaming_pr1(mt, st_t, ep_t, mt.all_outcomes(ep_t))
    assert (pr1_t is None) == (pr1_j is None) == (name in GENERAL)
    if pr1_t is not None:
        np.testing.assert_allclose(pr1_t.numpy(), np.asarray(pr1_j),
                                   rtol=RTOL, atol=ATOL)
        # Outcomes other than [0, 1] take the general route.
        assert tsmc._streaming_pr1(mt, st_t, ep_t,
                                   np.array([1, 0])) is None


@pytest.mark.parametrize("name", STREAMING + GENERAL)
def test_hypothetical_log_update_matches_jax(name):
    mj, mt, st_j, st_t, ep_j, ep_t = _both(name)
    outcomes = np.array(mj.all_outcomes(ep_j))[:25]
    lw_j, ln_j = jsmc.hypothetical_log_update(mj, st_j, jnp.asarray(outcomes),
                                              ep_j)
    lw_t, ln_t = tsmc.hypothetical_log_update(mt, st_t,
                                              torch.from_numpy(outcomes), ep_t)
    n_exp = len(next(iter(ep_t.values())))
    assert lw_t.shape == lw_j.shape == (len(outcomes), n_exp, N)
    np.testing.assert_allclose(ln_t.numpy(), np.asarray(ln_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(torch.exp(lw_t).numpy(),
                               np.exp(np.asarray(lw_j)), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", STREAMING + GENERAL)
def test_bayes_risk_matches_jax(name):
    mj, mt, st_j, st_t, ep_j, ep_t = _both(name)
    risk_j = jsmc.bayes_risk_fn(mj, st_j, ep_j, Q=mj.Q,
                                outcomes=mj.all_outcomes(ep_j))
    risk_t = tsmc.bayes_risk_fn(mt, st_t, ep_t, Q=mt.Q,
                                outcomes=mt.all_outcomes(ep_t))
    assert risk_t.shape == risk_j.shape and bool((risk_t > 0).all())
    np.testing.assert_allclose(risk_t.numpy(), np.asarray(risk_j),
                               rtol=RTOL, atol=ATOL)
    # Q defaults to ones; a weighting is applied per coordinate.
    q = np.linspace(0.5, 2.0, mt.n_modelparams).astype(np.float32)
    np.testing.assert_allclose(
        tsmc.bayes_risk_fn(mt, st_t, ep_t, Q=q).numpy(),
        np.asarray(jsmc.bayes_risk_fn(mj, st_j, ep_j, Q=jnp.asarray(q))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", STREAMING + GENERAL)
def test_expected_information_gain_matches_jax(name):
    mj, mt, st_j, st_t, ep_j, ep_t = _both(name)
    ig_j = jsmc.expected_information_gain_fn(mj, st_j, ep_j)
    ig_t = tsmc.expected_information_gain_fn(mt, st_t, ep_t)
    assert ig_t.shape == ig_j.shape and bool(torch.isfinite(ig_t).all())
    np.testing.assert_allclose(ig_t.numpy(), np.asarray(ig_j), rtol=RTOL,
                               atol=ATOL)


def _updaters(name, seed=0):
    """A JAX and a port SMCUpdater on one state."""
    model_j, locs, ep = _case(name)
    ju = qi.SMCUpdater(model_j, N, qi.UniformDistribution([[0, 1]] *
                                                          locs.shape[1]),
                       seed=seed)
    st_j, st_t = _states(locs, 2)
    ju.state = st_j
    tu = qt.SMCUpdater(from_reference(model_j), N,
                       qt.UniformDistribution([[0, 1]] * locs.shape[1]),
                       seed=seed, device="cpu")
    tu.state = st_t
    return ju, tu, ep


@pytest.mark.parametrize("name", ["precession", "binomial_precession"])
def test_updater_design_takes_record_arrays(name):
    """Record-array expparams (the reference's native format) give what the
    dict form gives, in both packages, with the model's Q."""
    ju, tu, ep = _updaters(name)
    fields = [(k, np.asarray(v).dtype) for k, v in ep.items()]
    rec = np.zeros(len(ep["t"]), dtype=fields)
    for k, v in ep.items():
        rec[k] = v
    for fn in ("bayes_risk", "expected_information_gain"):
        got = getattr(tu, fn)(rec)
        np.testing.assert_allclose(got.numpy(), getattr(tu, fn)(ep).numpy(),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(ju, fn)(rec)),
                                   rtol=RTOL, atol=ATOL)


def test_updater_design_returns_a_scalar_for_one_candidate():
    ju, tu, ep = _updaters("tomography")
    one = {"meas": ep["meas"][:1]}
    for fn in ("bayes_risk", "expected_information_gain"):
        got = getattr(tu, fn)(one)
        assert got.shape == () == np.shape(getattr(ju, fn)(one))
        np.testing.assert_allclose(float(got), float(getattr(ju, fn)(one)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["tomography", "binomial_precession"])
def test_hypothetical_update_matches_jax(name):
    ju, tu, ep = _updaters(name)
    outcomes = np.array([0, 1])
    w_j, norm_j, L_j = ju.hypothetical_update(
        jnp.asarray(outcomes), {k: jnp.asarray(v) for k, v in ep.items()},
        return_likelihood=True, return_normalization=True)
    w_t, norm_t, L_t = tu.hypothetical_update(outcomes, ep,
                                              return_likelihood=True,
                                              return_normalization=True)
    assert w_t.shape == w_j.shape and norm_t.shape == norm_j.shape
    assert L_t.shape == L_j.shape
    for t, j in ((w_t, w_j), (norm_t, norm_j), (L_t, L_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    assert tu._call_count == 2 * N * len(next(iter(ep.values())))
    assert tu.hypothetical_update(1, ep).shape == (1,) + w_t.shape[1:]


def test_estimators_match_jax():
    ju, tu, _ = _updaters("tomography")
    np.testing.assert_allclose(float(tu.est_entropy()),
                               float(ju.est_entropy()), rtol=1e-5)
    fn_t = tu.est_meanfn(lambda x: x ** 2)
    fn_j = ju.est_meanfn(lambda x: x ** 2)
    np.testing.assert_allclose(fn_t.numpy(), np.asarray(fn_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tu.est_meanfn(lambda x: x).numpy(),
                               tu.est_mean().numpy(), rtol=1e-6)


def test_reset_replays_or_redraws_the_cloud():
    basis = qt.tomography.pauli_basis(1)
    u = qt.SMCUpdater(qt.tomography.TomographyModel(basis), 256,
                      qt.tomography.GinibreDistribution(basis), seed=4,
                      device="cpu")
    first = u.particle_locations.clone()
    u.update(1, {"meas": np.array([[0.5, 0.5, 0.0, 0.0]], np.float32)})
    assert len(u.data_record) == 1
    u.reset(fresh_rng=False)
    assert torch.equal(u.particle_locations, first)
    assert u.data_record == [] and u.normalization_record == []
    assert float(u.est_entropy()) == pytest.approx(np.log(256), rel=1e-6)
    u.reset()
    assert not torch.equal(u.particle_locations, first)
    u.reset(n_particles=128)
    assert u.particle_locations.shape == (128, 4) and u.n_particles == 128
    with pytest.raises(NotImplementedError):
        u.reset(only_params=[0])


def test_design_follows_the_device():
    """all_outcomes lies on the device of the expparams' tensors (the CPU for
    numpy); Q is built on the CPU and moved by bayes_risk_fn; outcomes on a
    device are never read back: the streaming route accepts them only for
    the default arange enumeration."""
    model = qt.tomography.TomographyModel(qt.tomography.pauli_basis(1))
    binom = qt.BinomialModel(qt.SimplePrecessionModel())
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert model.all_outcomes({"meas": np.zeros((2, 4))}).device == cpu
    assert model.all_outcomes().device == cpu
    assert model.all_outcomes({"meas": torch.zeros(2, 4)}).device == cpu
    assert model.all_outcomes({"meas": torch.zeros(2, 4,
                                                   device=meta)}).device == meta
    ep = {"t": torch.ones(2, device=meta),
          "n_meas": np.array([3, 5])}
    out = binom.all_outcomes(ep)
    assert out.device == meta and out.shape == (6,)
    assert model.Q.device == cpu

    _, _, st_j, st_t, _, ep_t = _both("tomography")
    device_outcomes = torch.arange(2, dtype=torch.int32, device=meta)
    pr1 = tsmc._streaming_pr1(model, st_t, ep_t, device_outcomes)
    assert pr1 is not None and pr1.shape == (N, 3)

    class Relabelled(qt.tomography.TomographyModel):
        def all_outcomes(self, expparams=None):
            return torch.tensor([1, 0], dtype=torch.int32)

    relabelled = Relabelled(qt.tomography.pauli_basis(1))
    assert tsmc._streaming_pr1(relabelled, st_t, ep_t,
                               device_outcomes) is None
    risk = tsmc.bayes_risk_fn(model, st_t, ep_t, Q=model.Q)
    assert risk.device == st_t.particle_locations.device
