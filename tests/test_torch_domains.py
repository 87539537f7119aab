"""The port's outcome domains against the JAX package (CPU), exactly.

Each domain is built with ``interop.from_reference`` from the JAX one;
its metadata, its enumerated ``values`` (in the JAX package's order) and
its ``in_domain`` mask on the same NumPy points must be identical. The
models' ``domain`` and ``all_outcomes`` are compared the same way.
"""

import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.interop import from_reference

DOMAINS = [
    qi.RealDomain(),
    qi.RealDomain(min=-1.0),
    qi.RealDomain(min=0.0, max=2.5),
    qi.IntegerDomain(),
    qi.IntegerDomain(min=2, max=9),
    qi.MultinomialDomain(n_meas=4, n_elements=3),
    qi.MultinomialDomain(n_meas=20, n_elements=3),
    qi.MultinomialDomain(n_meas=3, n_elements=5),
    qi.MultinomialDomain(n_meas=0, n_elements=2),
]


def _points(dom):
    rng = np.random.default_rng(0)
    if isinstance(dom, qi.MultinomialDomain):
        pts = rng.integers(-1, dom.n_meas + 2, size=(200, dom.n_elements))
        return np.concatenate([pts, np.asarray(dom.values)]).astype(np.int32)
    return np.concatenate([rng.normal(0.0, 5.0, 200),
                           np.arange(-3, 12), [0.5, 2.5, 9.0]]).astype(
                               np.float32)


@pytest.mark.parametrize("dom_j", DOMAINS, ids=repr)
def test_domain_matches_jax(dom_j):
    dom_t = from_reference(dom_j)
    assert type(dom_t).__name__ == type(dom_j).__name__
    assert type(dom_t).__module__ == "qinfer_tpu_torch.domains"
    assert dom_t.is_continuous == dom_j.is_continuous
    assert dom_t.is_finite == dom_j.is_finite
    assert dom_t.n_members == dom_j.n_members
    assert str(dom_t.dtype).split(".")[-1] == np.dtype(dom_j.dtype).name
    if dom_j.is_finite:
        vals = dom_t.values
        assert vals.dtype == torch.int32
        np.testing.assert_array_equal(vals.numpy(), np.asarray(dom_j.values))
        assert vals.shape[0] == dom_t.n_members
    pts = _points(dom_j)
    np.testing.assert_array_equal(
        dom_t.in_domain(torch.from_numpy(pts)).numpy(),
        np.asarray(dom_j.in_domain(pts)))


def test_integer_points_and_unbounded_enumeration():
    dom = qt.IntegerDomain(min=0, max=4)
    np.testing.assert_array_equal(
        dom.in_domain(torch.tensor([-1, 0, 4, 5])).numpy(),
        [False, True, True, False])
    with pytest.raises(ValueError):
        qt.IntegerDomain().values
    assert qt.IntegerDomain().n_members is None


def test_multinomial_domain_regular_arrays_and_members():
    dom = qt.MultinomialDomain(n_meas=20, n_elements=3)
    vals = dom.values
    assert vals.shape == (231, 3)
    assert bool(dom.in_domain(vals).all())
    assert bool((vals.sum(1) == 20).all())
    assert len({tuple(v) for v in vals.tolist()}) == 231
    a = np.array([[1, 2, 17]], np.int32)
    np.testing.assert_array_equal(dom.to_regular_array(a).numpy(), a)
    np.testing.assert_array_equal(dom.from_regular_array(a).numpy(), a)


@pytest.mark.parametrize("model_j,ep", [
    (qi.SimplePrecessionModel(), {"t": np.array([1.0], np.float32)}),
    (qi.NDieModel(n=4), {"exp_num": np.array([0], np.int32)}),
    (qi.BinomialModel(qi.CoinModel()),
     {"dummy": np.zeros(2, np.float32), "n_meas": np.array([3, 7])}),
    (qi.MultinomialModel(qi.NDieModel(n=3)),
     {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([6, 4])}),
    (qi.ReferencedPoissonModel(qi.CoinModel(), max_rate=30.0),
     {"dummy": np.zeros(1, np.float32), "mode": np.array([0])}),
], ids=lambda v: type(v).__name__ if not isinstance(v, dict) else "")
def test_model_domains_and_outcomes_match_jax(model_j, ep):
    model_t = from_reference(model_j)
    d_t, d_j = model_t.domain(ep), model_j.domain(ep)
    assert type(d_t).__name__ == type(d_j).__name__
    assert d_t.n_members == d_j.n_members
    if d_j.is_finite:
        np.testing.assert_array_equal(d_t.values.numpy(),
                                      np.asarray(d_j.values))
    assert model_t.n_outcomes(ep) == model_j.n_outcomes(ep)
    outs = model_t.all_outcomes(ep)
    assert outs.dtype == torch.int32
    np.testing.assert_array_equal(outs.numpy(),
                                  np.asarray(model_j.all_outcomes(ep)))
    assert model_t.outcome_ndim == getattr(model_j, "outcome_ndim", 0)
