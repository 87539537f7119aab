"""Port parity for ``ExperimentDesigner`` (CPU).

The JAX updater is trained on a short record, and its state is carried to
the port (``state_from_numpy``). On that state the design objective
(Bayes risk, plus the experiment cost) and its gradient, from
``torch.autograd`` in the port and ``jax.value_and_grad`` in the JAX
package, agree within rtol 1e-4; a design from the same guess lands on the
same time within the optimizer's own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

torch.set_num_threads(2)


def _trained_pair(model_j, n=2000, n_exp=15, seed=0, n_meas=None):
    """A JAX updater after n_exp exp-sparse updates at ω = 0.55, and a port
    updater on the same state."""
    prior = qi.UniformDistribution([0.0, 1.0])
    ju = qi.SMCUpdater(model_j, n, prior, seed=seed)
    for k in range(n_exp):
        ep = {"t": jnp.array([(9 / 8) ** k], jnp.float32)}
        if n_meas is not None:
            ep["n_meas"] = jnp.array([n_meas], jnp.int32)
        out = model_j.simulate_experiment(
            jax.random.PRNGKey(50 + k), jnp.array([[0.55]]), ep)[0, 0, 0]
        ju.update(out, ep)
    tu = qt.SMCUpdater(from_reference(model_j), n,
                       qt.UniformDistribution([0.0, 1.0]), seed=seed,
                       device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    return ju, tu


@pytest.fixture(scope="module")
def precession_pair():
    return _trained_pair(qi.SimplePrecessionModel())


@pytest.mark.parametrize("t", [0.5, 3.0, 10.0])
@pytest.mark.parametrize("cost_mult,k", [(False, 0.0), (True, 0.5)])
def test_objective_value_and_gradient_match_jax(precession_pair, t,
                                                cost_mult, k):
    ju, tu = precession_pair
    dj, dt = qi.ExperimentDesigner(ju), qt.ExperimentDesigner(tu)
    outcomes = np.arange(2, dtype=np.int32)
    val_j, grad_j = dj._value_and_grad(
        ju.state, jnp.asarray([t], jnp.float32), {}, jnp.asarray(outcomes),
        "t", (1,), k, cost_mult)
    val_t, grad_t = dt._value_and_grad(
        torch.tensor([t]), {}, torch.from_numpy(outcomes), "t", (1,), k,
        cost_mult)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-4)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-4,
                               atol=1e-9)


def test_binomial_objective_matches_jax():
    ju, tu = _trained_pair(qi.BinomialModel(qi.SimplePrecessionModel()),
                           n=1024, n_exp=8, n_meas=10)
    dj, dt = qi.ExperimentDesigner(ju), qt.ExperimentDesigner(tu)
    rest_j = {"n_meas": jnp.asarray([10], jnp.int32)}
    rest_t = {"n_meas": torch.tensor([10])}
    outcomes = np.arange(11, dtype=np.int32)
    for t in (0.7, 4.0):
        val_j, grad_j = dj._value_and_grad(
            ju.state, jnp.asarray([t], jnp.float32), rest_j,
            jnp.asarray(outcomes), "t", (1,), 0.0, False)
        val_t, grad_t = dt._value_and_grad(
            torch.tensor([t]), rest_t, torch.from_numpy(outcomes), "t", (1,),
            0.0, False)
        np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-4)
        np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("guess", [1.0, 2.5])
def test_design_from_the_same_guess_matches_jax(precession_pair, guess):
    """CG from the same guess: the same local optimum within the
    optimizer's tolerance (gtol 1e-5 on a gradient of order 1e-3 per unit
    of t: a few parts in 1e3), and never worse than the guess."""
    ju, tu = precession_pair
    ep_j = qi.ExperimentDesigner(ju).design_expparams_field(
        {"t": jnp.array([guess], jnp.float32)}, "t", cost_scale_k=0.0,
        maxiter=20)
    ep_t = qt.ExperimentDesigner(tu).design_expparams_field(
        {"t": np.array([guess], np.float32)}, "t", cost_scale_k=0.0,
        maxiter=20)
    t_j, t_t = float(ep_j["t"][0]), float(ep_t["t"][0])
    assert t_t == pytest.approx(t_j, rel=5e-3)
    risk_guess = float(tu.bayes_risk({"t": np.array([guess], np.float32)}))
    assert float(tu.bayes_risk(ep_t)) <= risk_guess + 1e-9
    assert ep_t["t"].shape == (1,) and ep_t["t"].dtype == torch.float32


def test_design_with_a_heuristic_guess_store_and_projection(precession_pair):
    _, tu = precession_pair
    designer = qt.ExperimentDesigner(
        tu, opt_algo=qt.OptimizationAlgorithms.NELDER_MEAD)
    designer.new_exp()
    ep = designer.design_expparams_field(qt.PGH(tu), "t", store_guess=True,
                                         maxiter=10)
    assert float(ep["t"][0]) > 0
    ep2 = designer.design_expparams_field(
        qt.PGH, "t", store_guess=True, maxiter=10,
        project=lambda x: np.clip(x, 0.1, 3.0))
    assert 0.1 <= float(ep2["t"][0]) <= 50.0
    clipped = qt.ExperimentDesigner(tu).design_expparams_field(
        {"t": [9.0]}, "t", maxiter=5, project=lambda x: np.clip(x, 0.1, 3.0))
    assert 0.1 <= float(clipped["t"][0]) <= 3.0
    with pytest.raises(TypeError, match="guess"):
        designer.design_expparams_field(42, "t")
    assert qt.ExperimentDesigner(tu, "CG")._opt_algo is (
        qt.OptimizationAlgorithms.CG)


def test_experiment_cost_is_one_per_experiment():
    cost = qt.SimplePrecessionModel().experiment_cost(
        {"t": torch.tensor([1.0, 2.0, 3.0])})
    assert cost.dtype == torch.float32 and cost.tolist() == [1.0, 1.0, 1.0]
