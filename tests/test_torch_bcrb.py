"""The score, the Fisher information and ``SMCUpdaterBCRB`` of the port
against the JAX package (CPU).

Scores and Fisher information at rtol 1e-5 on banks drawn with numpy (an
absolute floor of 1e-5 of the largest |score| covers the scores that cancel
to near zero, where f32 libm differences between the two packages are
relative); the BIM after updates on a bank and a BIM carried across
(``state_from_numpy`` and ``initial_bim``) at rtol 1e-5; the cos² identity
BIM = Σ t² within 1e-3 in both packages; the zero-likelihood particle and
the ``batch_update`` quirk as the JAX package has them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
from qinfer_tpu.models.base import DifferentiableModel as JaxDifferentiable
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

torch.set_num_threads(2)

N = 1000

# (JAX model, prior box, expparams of one experiment), with boxes and times
# that keep pr0 away from 0 and 1: there f32 rounding of cos² (which the
# two packages' libms round differently) is amplified by 1/(1 − pr0).
SCORE_CASES = {
    "precession": (qi.SimplePrecessionModel(), [[0.3, 1.0]],
                   {"t": [2.3]}),
    "multicos": (qi.MultiCosModel(n_terms=2), [[0.1, 1.0], [0.1, 1.0]],
                 {"ts": [[1.3, 0.7]]}),
    "known_t2": (qi.KnownT2PrecessionModel(t2=30.0), [[0.1, 1.0]],
                 {"t": [7.0]}),
    "rb": (qi.rb.RandomizedBenchmarkingModel(),
           [[0.8, 1.0], [0.2, 0.5], [0.3, 0.5]], {"m": [16.0]}),
    "binomial_precession": (qi.BinomialModel(qi.SimplePrecessionModel()),
                            [[0.3, 1.0]], {"t": [2.0], "n_meas": [10]}),
}


def _bank(box, n, seed):
    box = np.asarray(box, np.float64)
    rng = np.random.default_rng(seed)
    return (box[:, 0] + (box[:, 1] - box[:, 0])
            * rng.random((n, len(box)))).astype(np.float32)


def _eps(ep, lib):
    return {k: lib.asarray(np.asarray(v)) if lib is jnp
            else torch.as_tensor(np.asarray(v)) for k, v in ep.items()}


@pytest.mark.parametrize("name", list(SCORE_CASES))
def test_score_and_fisher_match_jax(name):
    model_j, box, ep = SCORE_CASES[name]
    model_t = from_reference(model_j)
    locs = _bank(box, N, 1)
    ep_j, ep_t = _eps(ep, jnp), _eps(ep, torch)
    outcomes = np.array(model_j.all_outcomes(ep_j))
    sc_j = np.asarray(JaxDifferentiable.score(model_j, jnp.asarray(outcomes),
                                              jnp.asarray(locs), ep_j))
    sc_t = qt.DifferentiableModel.score(model_t, torch.as_tensor(outcomes),
                                        torch.from_numpy(locs), ep_t).numpy()
    assert sc_t.shape == sc_j.shape == (len(box), len(outcomes), N, 1)
    scale = np.abs(sc_j).max()
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5, atol=1e-5 * scale)
    L_j = np.asarray(model_j.likelihood(jnp.asarray(outcomes),
                                        jnp.asarray(locs), ep_j))
    fi_j = np.einsum("one,ione,jone->ijne", L_j, sc_j, sc_j)
    fi_t = qt.DifferentiableModel.fisher_information(
        model_t, torch.from_numpy(locs), ep_t).numpy()
    np.testing.assert_allclose(fi_t, fi_j, rtol=1e-5,
                               atol=1e-5 * np.abs(fi_j).max())


def test_score_mixin_and_fisher_of_precession_is_t_squared():
    """tests/test_expdesign.py:91-98, and the cos² identity F = t²."""

    class M(qt.ScoreMixin, qt.SimplePrecessionModel):
        pass

    m = M()
    params = torch.tensor([[0.5], [0.2], [0.9]])
    ep = {"t": torch.tensor([2.0, 3.5])}
    fi = m.fisher_information(params, ep)
    assert fi.shape == (1, 1, 3, 2) and bool((fi >= 0).all())
    np.testing.assert_allclose(fi[0, 0].numpy(),
                               np.broadcast_to([4.0, 12.25], (3, 2)),
                               rtol=1e-5)


def test_finite_difference_matches_jax_and_gradient():
    """tests/test_expdesign.py:82-88 in both packages."""
    f = lambda x, y: x ** 2 + 3 * y  # noqa: E731
    grad_t = qt.FiniteDifference(f, 2, h=1e-4)([2.0, 1.0])
    grad_j = qi.FiniteDifference(f, 2, h=1e-4)([2.0, 1.0])
    np.testing.assert_allclose(grad_t, [4.0, 3.0], atol=1e-2)
    np.testing.assert_array_equal(grad_t, grad_j)
    h = qt.FiniteDifference(f, 2, h=[1e-3, 1e-2])
    np.testing.assert_array_equal(h.h, [1e-3, 1e-2])


def _record(n_exp, seed):
    rng = np.random.default_rng(seed)
    ts = ((9 / 8) ** np.arange(n_exp)).astype(np.float32)
    outcomes = (rng.random(n_exp)
                >= np.cos(0.5 * 0.5 * ts) ** 2).astype(np.int32)
    return ts, outcomes


def test_bim_after_updates_on_a_carried_bank_matches_jax():
    """Five updates in JAX, the bank and BIM carried into the port, then ten
    more updates in both without resampling: BIM and BCRB at rtol 1e-5."""
    model_j = qi.SimplePrecessionModel()
    ju = qi.SMCUpdaterBCRB(model_j, N, qi.UniformDistribution([0, 1]),
                           seed=0, resample_thresh=0.0,
                           initial_bim=np.eye(1) * 12.0)
    ts, outcomes = _record(15, 0)
    for t, o in zip(ts[:5], outcomes[:5]):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
    tu = qt.SMCUpdaterBCRB(from_reference(model_j), N,
                           qt.UniformDistribution([0, 1]), seed=0,
                           resample_thresh=0.0, device="cpu",
                           initial_bim=np.asarray(ju.current_bim))
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    for t, o in zip(ts[5:], outcomes[5:]):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
        tu.update(int(o), {"t": np.array([t])})
    assert ju.resample_count == tu.resample_count == 0
    np.testing.assert_allclose(tu.current_bim.numpy(),
                               np.asarray(ju.current_bim), rtol=1e-5)
    np.testing.assert_allclose(tu.current_bcrb.numpy(),
                               np.asarray(ju.current_bcrb), rtol=1e-5)
    np.testing.assert_allclose(tu.est_mean().numpy(),
                               np.asarray(ju.est_mean()), rtol=1e-5)


def test_non_adaptive_bim_averages_the_initial_prior():
    """adaptive=False: each increment is the Fisher information averaged
    over the construction-time cloud, in both packages."""
    model_j = qi.KnownT2PrecessionModel(t2=30.0)
    ju = qi.SMCUpdaterBCRB(model_j, N, qi.UniformDistribution([0, 1]),
                           seed=0, adaptive=False)
    tu = qt.SMCUpdaterBCRB(from_reference(model_j), N,
                           qt.UniformDistribution([0, 1]), seed=0,
                           adaptive=False, device="cpu")
    init = jax.tree_util.tree_map(np.asarray, ju.state)
    tu.state = state_from_numpy(init)
    tu._initial_prior_locs = tu.state.particle_locations
    tu._initial_prior_log_w = tu.state.particle_log_weights
    ts, outcomes = _record(12, 1)
    for t, o in zip(ts, outcomes):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
        tu.update(int(o), {"t": np.array([t])})
    assert tu.resample_count > 0
    np.testing.assert_allclose(tu.current_bim.numpy(),
                               np.asarray(ju.current_bim), rtol=1e-5)


def test_bim_is_sum_of_t_squared_in_both_packages():
    """For cos² every particle's Fisher information is t², so with
    resampling the BIM is Σ t² in both packages (within 1e-3: the weight
    of particles whose score is zeroed at L ≤ 1e-10)."""
    ts, outcomes = _record(40, 2)
    sum_t2 = float(np.sum(ts.astype(np.float64) ** 2))
    ju = qi.SMCUpdaterBCRB(qi.SimplePrecessionModel(), 4096,
                           qi.UniformDistribution([0, 1]), seed=0,
                           zero_weight_policy="reset")
    tu = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 4096,
                           qt.UniformDistribution([0, 1]), seed=0,
                           zero_weight_policy="reset", device="cpu")
    for t, o in zip(ts, outcomes):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
        tu.update(int(o), {"t": np.array([t])})
    assert ju.resample_count > 0 and tu.resample_count > 0
    assert float(ju.current_bim[0, 0]) == pytest.approx(sum_t2, rel=1e-3)
    assert float(tu.current_bim[0, 0]) == pytest.approx(sum_t2, rel=1e-3)


def test_zero_likelihood_particle_keeps_the_bim_finite():
    """tests/test_round5_fixes.py:336-356 in the port: a particle on a
    likelihood zero, plain and binomial; the port's BIM equals JAX's on the
    same bank."""
    for model_j, ep, outcome in (
            (qi.SimplePrecessionModel(), {"t": [2.0 * np.pi]}, 1),
            (qi.BinomialModel(qi.SimplePrecessionModel()),
             {"t": [2.0 * np.pi], "n_meas": [10.0]}, 3)):
        ju = qi.SMCUpdaterBCRB(model_j, 256, qi.UniformDistribution([0, 1]),
                               seed=0)
        locs = ju.state.particle_locations.at[0, 0].set(0.5)
        ju.state = ju.state._replace(particle_locations=locs)
        tu = qt.SMCUpdaterBCRB(from_reference(model_j), 256,
                               qt.UniformDistribution([0, 1]), seed=0,
                               device="cpu")
        tu.state = state_from_numpy(
            jax.tree_util.tree_map(np.asarray, ju.state))
        ep_j = {k: jnp.asarray(np.asarray(v, np.float32))
                for k, v in ep.items()}
        ju.update(jnp.int32(outcome), ep_j)
        tu.update(outcome, {k: np.asarray(v, np.float32)
                            for k, v in ep.items()})
        bim = tu.current_bim.numpy()
        assert np.isfinite(bim).all()
        np.testing.assert_allclose(bim, np.asarray(ju.current_bim),
                                   rtol=1e-5)


def test_batch_update_accumulates_no_bim_in_either_package():
    """The JAX package's ``batch_update`` bypasses ``SMCUpdaterBCRB.update``
    and adds nothing to the BIM; the port keeps that. Under divergence
    tracking both replay through ``update`` and do accumulate."""
    ts, outcomes = _record(6, 3)
    bims = {}
    for track in (False, True):
        ju = qi.SMCUpdaterBCRB(qi.SimplePrecessionModel(), 512,
                               qi.UniformDistribution([0, 1]), seed=0,
                               initial_bim=np.eye(1),
                               track_resampling_divergence=track)
        tu = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 512,
                               qt.UniformDistribution([0, 1]), seed=0,
                               initial_bim=np.eye(1), device="cpu",
                               track_resampling_divergence=track)
        ju.batch_update(jnp.asarray(outcomes), {"t": jnp.asarray(ts)})
        tu.batch_update(outcomes, {"t": ts})
        assert len(tu.data_record) == len(ju.data_record) == len(ts)
        bims[track] = (float(ju.current_bim[0, 0]),
                       float(tu.current_bim[0, 0]))
    assert bims[False] == (1.0, 1.0)
    sum_t2 = 1.0 + float(np.sum(ts.astype(np.float64) ** 2))
    assert bims[True][0] == pytest.approx(sum_t2, rel=1e-3)
    assert bims[True][1] == pytest.approx(sum_t2, rel=1e-3)


def test_new_updaters_default_to_the_card(monkeypatch):
    """Both updaters take device="cuda" by default and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prior = qt.UniformDistribution([0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 16, prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.MixedApproximateSMCUpdater(qt.SimplePrecessionModel(),
                                      qt.AcceleratedPrecessionModel(), 16,
                                      prior)
    u = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 16, prior,
                          device="cpu")
    assert u.current_bim.device.type == "cpu"
