"""The port's distributions and multinomial utilities against the JAX
package (CPU).

Every distribution is built with ``interop.from_reference`` from the JAX
one. The two packages cannot share random streams, so samples are held
against each other by moments: at n = 2^14 draws each, every mean and
every covariance entry agrees within five joint standard errors, and each
sample keeps its distribution's constraints (supports, row sums).
``grad_log_pdf`` and ``log_multinomial_pdf`` are deterministic and agree
at rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.utils as ju
import qinfer_tpu_torch as qt
from qinfer_tpu_torch import utils as tu
from qinfer_tpu_torch.interop import from_reference

torch.set_num_threads(2)

N = 1 << 14


def _gauss_pdf(x):
    return np.exp(-0.5 * (x - 0.3) ** 2 / 0.8)


# (id, JAX distribution, constraint on the (n, d) sample as numpy)
CASES = [
    ("uniform", qi.UniformDistribution([[0.0, 1.0], [-2.0, 3.0]]),
     lambda s: (s[:, 0] >= 0).all() and (s[:, 1] <= 3).all()),
    ("mv_uniform", qi.MVUniformDistribution(dim=4),
     lambda s: (s >= 0).all() and np.allclose(s.sum(1), 1.0, atol=1e-5)),
    ("discrete_uniform", qi.DiscreteUniformDistribution(num_bits=3),
     lambda s: (s == np.round(s)).all() and s.min() >= 0 and s.max() < 8),
    ("constant", qi.ConstantDistribution([0.25, -1.5]),
     lambda s: (s == np.float32([0.25, -1.5])).all()),
    ("normal", qi.NormalDistribution(0.5, 2.0), lambda s: True),
    ("normal_trunc", qi.NormalDistribution(1.0, 4.0, trunc=(0.0, 2.5)),
     lambda s: s.min() >= 0.0 and s.max() <= 2.5),
    ("normal_tail", qi.NormalDistribution(0.0, 1.0, trunc=(2.0, 6.0)),
     lambda s: s.min() >= 2.0 and s.max() <= 6.0),
    ("mv_normal", qi.MultivariateNormalDistribution(
        [0.0, 1.0, -1.0], [[1.0, 0.5, 0.1], [0.5, 2.0, -0.3],
                           [0.1, -0.3, 0.5]]), lambda s: True),
    ("slanted_normal", qi.SlantedNormalDistribution([[0.0, 1.0], [2.0, 4.0]],
                                                    weight=0.1),
     lambda s: True),
    ("log_normal", qi.LogNormalDistribution(mu=-0.5, sigma=0.4),
     lambda s: (s > 0).all()),
    ("beta", qi.BetaDistribution(alpha=2.0, beta=5.0),
     lambda s: (s >= 0).all() and (s <= 1).all()),
    ("beta_mean_var", qi.BetaDistribution(mean=0.3, var=0.01),
     lambda s: (s >= 0).all() and (s <= 1).all()),
    ("beta_binomial", qi.BetaBinomialDistribution(12, alpha=2.0, beta=3.0),
     lambda s: (s == np.round(s)).all() and s.min() >= 0 and s.max() <= 12),
    ("beta_binomial_mean_var",
     qi.BetaBinomialDistribution(10, mean=4.0, var=6.0),
     lambda s: (s == np.round(s)).all() and s.min() >= 0 and s.max() <= 10),
    ("gamma", qi.GammaDistribution(alpha=3.0, beta=2.0),
     lambda s: (s > 0).all()),
    ("gamma_mean_var", qi.GammaDistribution(mean=2.0, var=0.5),
     lambda s: (s > 0).all()),
    ("product", qi.ProductDistribution(qi.NormalDistribution(1.0, 0.25),
                                       qi.UniformDistribution([0.0, 2.0]),
                                       qi.GammaDistribution(2.0, 1.0)),
     lambda s: s[:, 1].min() >= 0 and (s[:, 2] > 0).all()),
    ("mixture", qi.MixtureDistribution(
        [1.0, 3.0], [qi.NormalDistribution(-1.0, 0.5),
                     qi.NormalDistribution(2.0, 0.1)]), lambda s: True),
    ("mixture_of_class", qi.MixtureDistribution(
        [0.2, 0.8], qi.NormalDistribution, dist_args=[[0.0, 1.0],
                                                      [3.0, 0.25]]),
     lambda s: True),
    ("constrained_sum", qi.ConstrainedSumDistribution(
        qi.UniformDistribution([[0.0, 1.0]] * 3), desired_total=2.0),
     lambda s: np.allclose(s.sum(1), 2.0, atol=1e-5)),
    ("postselected", qi.PostselectedDistribution(
        qi.NormalDistribution(0.5, 0.25), qi.SimplePrecessionModel()),
     lambda s: (s >= 0).all()),
    ("interpolated", qi.InterpolatedUnivariateDistribution(
        _gauss_pdf, compactification_scale=2.0, n_interp_points=800),
     lambda s: True),
]


def _moment_se(s):
    """(mean, cov, se(mean), se(cov)) of an (n, d) sample in f64."""
    s = s.astype(np.float64)
    n = s.shape[0]
    mu = s.mean(0)
    c = s - mu
    prods = c[:, :, None] * c[:, None, :]
    return mu, prods.mean(0), s.std(0) / np.sqrt(n), prods.std(0) / np.sqrt(n)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_samples_match_jax_by_moments(case):
    _, dist_j, constraint = case
    dist_t = from_reference(dist_j)
    assert type(dist_t).__name__ == type(dist_j).__name__
    assert dist_t.n_rvs == dist_j.n_rvs
    s_j = np.asarray(dist_j.sample(jax.random.PRNGKey(3), N))
    s_t = dist_t.sample(torch.Generator().manual_seed(3), N)
    assert s_t.dtype == torch.float32
    s_t = s_t.numpy()
    assert s_t.shape == s_j.shape == (N, dist_j.n_rvs)
    assert np.all(np.isfinite(s_t))
    assert constraint(s_t) and constraint(s_j)
    mu_t, cov_t, se_mu_t, se_cov_t = _moment_se(s_t)
    mu_j, cov_j, se_mu_j, se_cov_j = _moment_se(s_j)
    tol_mu = 5 * np.sqrt(se_mu_t ** 2 + se_mu_j ** 2) + 1e-7
    tol_cov = 5 * np.sqrt(se_cov_t ** 2 + se_cov_j ** 2) + 1e-7
    assert np.all(np.abs(mu_t - mu_j) < tol_mu), (mu_t, mu_j)
    assert np.all(np.abs(cov_t - cov_j) < tol_cov), (cov_t, cov_j)


def test_samples_follow_the_generator():
    """One seed, one sample; the draws come from the generator passed."""
    for _, dist_j, _ in CASES:
        d = from_reference(dist_j)
        a = d.sample(torch.Generator().manual_seed(5), 64)
        b = d.sample(torch.Generator().manual_seed(5), 64)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dist_j", [
    qi.UniformDistribution([[0.0, 1.0], [1.0, 2.0]]),
    qi.NormalDistribution(0.7, 0.3),
    qi.MultivariateNormalDistribution([0.2, -0.4], [[1.5, 0.3], [0.3, 0.7]]),
], ids=lambda d: type(d).__name__)
def test_grad_log_pdf_matches_jax(dist_j):
    x = np.random.default_rng(0).standard_normal(
        (50, dist_j.n_rvs)).astype(np.float32)
    if isinstance(dist_j, qi.NormalDistribution):
        x = x[:, :1]
    got = from_reference(dist_j).grad_log_pdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(dist_j.grad_log_pdf(x)),
                               rtol=1e-5, atol=1e-6)


def test_shape_parameters_from_mean_and_var_match_jax():
    for cls_t, cls_j, kw in (
            (qt.BetaDistribution, qi.BetaDistribution,
             {"mean": 0.3, "var": 0.01}),
            (qt.GammaDistribution, qi.GammaDistribution,
             {"mean": 2.0, "var": 0.5})):
        t, j = cls_t(**kw), cls_j(**kw)
        assert (t.alpha, t.beta) == (j.alpha, j.beta)
    t = qt.BetaBinomialDistribution(10, mean=4.0, var=6.0)
    j = qi.BetaBinomialDistribution(10, mean=4.0, var=6.0)
    assert (t.n, t.alpha, t.beta) == (j.n, j.alpha, j.beta)
    for cls in (qt.BetaDistribution, qt.GammaDistribution):
        with pytest.raises(ValueError):
            cls(alpha=1.0)


def test_composite_conversions_carry_their_parts():
    mix = from_reference(qi.MixtureDistribution(
        [1.0, 3.0], [qi.NormalDistribution(-1.0, 0.5),
                     qi.GammaDistribution(2.0, 1.0)]))
    assert mix.weights == pytest.approx((0.25, 0.75), rel=1e-12)
    assert [type(d).__name__ for d in mix.dist] == ["NormalDistribution",
                                                    "GammaDistribution"]
    post = from_reference(qi.PostselectedDistribution(
        qi.UniformDistribution([0.0, 1.0]), qi.SimplePrecessionModel(0.2),
        maxiters=7))
    assert isinstance(post.model, qt.SimplePrecessionModel)
    assert post.model.min_freq == 0.2 and post.maxiters == 7
    cs = from_reference(qi.ConstrainedSumDistribution(
        qi.MVUniformDistribution(3), desired_total=4.0))
    assert isinstance(cs.underlying_distribution, qt.MVUniformDistribution)
    assert cs.desired_total == 4.0
    locs = np.random.default_rng(1).random((20, 2)).astype(np.float32)
    pd = from_reference(qi.ParticleDistribution(locs))
    np.testing.assert_allclose(pd.est_mean().numpy(), locs.mean(0),
                               rtol=1e-5)


def test_interpolated_cdf_matches_jax():
    j = qi.InterpolatedUnivariateDistribution(_gauss_pdf, 2.0, 800)
    t = from_reference(j)
    np.testing.assert_array_equal(t._xs.numpy(), np.asarray(j._xs))
    np.testing.assert_array_equal(t._cdf.numpy(), np.asarray(j._cdf))
    # The same uniform draws through both interpolations.
    got = t.sample(torch.Generator().manual_seed(0), 101)
    u = torch.rand(101, generator=torch.Generator().manual_seed(0)).numpy()
    ref = np.interp(u, np.asarray(j._cdf), np.asarray(j._xs))
    np.testing.assert_allclose(got[:, 0].numpy(), ref, rtol=1e-5, atol=1e-6)


def test_single_sample_mixin():
    class Coin(qt.SingleSampleMixin, qt.Distribution):
        n_rvs = 2

        def _sample_one(self, generator):
            return torch.rand(2, generator=generator)

    s = Coin().sample(torch.Generator().manual_seed(0), 5)
    assert s.shape == (5, 2) and len(set(s[:, 0].tolist())) == 5


# -- multinomial utilities --------------------------------------------------------

def test_log_multinomial_pdf_matches_jax():
    rng = np.random.default_rng(0)
    ks = rng.multinomial(15, [0.2, 0.5, 0.3], size=(7, 4)).astype(np.int32)
    ps = rng.dirichlet(np.ones(3), size=(7, 4)).astype(np.float32)
    ps[0, 0] = [0.0, 0.4, 0.6]  # a clipped probability
    got = tu.log_multinomial_pdf(torch.from_numpy(ks), torch.from_numpy(ps))
    ref = np.asarray(ju.log_multinomial_pdf(jnp.asarray(ks), jnp.asarray(ps)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tu.multinomial_pdf(torch.from_numpy(ks), torch.from_numpy(ps)).numpy(),
        np.asarray(ju.multinomial_pdf(ks, ps)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ps", [(0.6, 0.3, 0.1), (0.05, 0.05, 0.2, 0.7),
                                (1.0, 0.0)], ids=["k3", "k4", "k2_edge"])
def test_sample_multinomial_matches_jax_by_moments(ps):
    n = np.array([5, 20], np.int32)
    shape = (N // 2, 2)
    got = tu.sample_multinomial(torch.Generator().manual_seed(0),
                                torch.from_numpy(n), torch.tensor(ps), shape)
    ref = np.asarray(ju.sample_multinomial(jax.random.PRNGKey(0),
                                           jnp.asarray(n), jnp.asarray(ps),
                                           shape=shape))
    assert got.dtype == torch.int32
    got = got.numpy()
    assert got.shape == ref.shape == shape + (len(ps),)
    assert (got >= 0).all()
    np.testing.assert_array_equal(got.sum(-1), np.broadcast_to(n, shape))
    for e in range(2):
        mu_t, cov_t, se_mu_t, se_cov_t = _moment_se(got[:, e])
        mu_j, cov_j, se_mu_j, se_cov_j = _moment_se(ref[:, e])
        assert np.all(np.abs(mu_t - mu_j)
                      <= 5 * np.sqrt(se_mu_t ** 2 + se_mu_j ** 2) + 1e-9)
        assert np.all(np.abs(cov_t - cov_j)
                      <= 5 * np.sqrt(se_cov_t ** 2 + se_cov_j ** 2) + 1e-9)
        np.testing.assert_allclose(mu_t, n[e] * np.asarray(ps),
                                   atol=5 * se_mu_t.max() + 1e-9)
