"""Prior distributions and the weighted particle cloud.

Counterpart of ``qinfer_tpu/distributions.py``: every distribution of the
JAX package, and the part of ``ParticleDistribution`` that ``SMCUpdater``
inherits. ``sample`` takes an explicit ``torch.Generator`` (which fixes
the device) where the JAX package takes a key, and every draw comes from
it: normals and uniforms from ``torch.randn`` / ``torch.rand``, Gamma (and
so Beta and Dirichlet) from ``torch._standard_gamma``, binomials from
``torch.binomial`` (both through ``utils``, which keeps consecutive calls
on a CUDA generator apart); the truncated normal is the inverse CDF
(``torch.special.ndtri``) of a uniform draw. Parameters and fixed tables
are built on the host, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np
import torch

from .utils import (
    binomial,
    compactspace,
    effective_sample_size,
    normalize_log_weights,
    particle_covariance_mtx,
    particle_mean,
    standard_gamma,
)

__all__ = [
    "Distribution", "SingleSampleMixin", "UniformDistribution",
    "MVUniformDistribution", "DiscreteUniformDistribution",
    "ConstantDistribution", "NormalDistribution",
    "MultivariateNormalDistribution", "SlantedNormalDistribution",
    "LogNormalDistribution", "BetaDistribution", "BetaBinomialDistribution",
    "GammaDistribution", "ProductDistribution", "MixtureDistribution",
    "PostselectedDistribution", "ConstrainedSumDistribution",
    "InterpolatedUnivariateDistribution", "ParticleDistribution",
]


class Distribution:
    """ABC: ``n_rvs`` and ``sample(generator, n) -> (n, n_rvs)`` f32 tensor
    on the generator's device."""

    @property
    def n_rvs(self) -> int:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, n: int = 1):
        raise NotImplementedError


class SingleSampleMixin:
    """Batched ``sample`` from a ``_sample_one(generator)`` implementation,
    called once per draw (the JAX package vmaps it over split keys)."""

    def sample(self, generator, n: int = 1):
        draws = [torch.as_tensor(self._sample_one(generator))
                 for _ in range(n)]
        return torch.stack(draws).reshape(n, self.n_rvs)


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _box(ranges):
    """``ranges`` as a tuple of (lo, hi) float pairs; (2,) is one pair."""
    arr = np.asarray(ranges, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None, :]
    return tuple(tuple(map(float, r)) for r in arr)


def _gamma(generator, alpha, shape):
    """Gamma(alpha, 1) draws of ``shape`` from ``generator``."""
    conc = torch.full(shape, float(alpha), dtype=torch.float32,
                      device=generator.device)
    return standard_gamma(conc, generator)


@dataclass(frozen=True, eq=False)
class UniformDistribution(Distribution):
    """Uniform over a box given by ``ranges`` of shape (d, 2) [or (2,)]."""

    ranges: Tuple[Tuple[float, float], ...]

    def __init__(self, ranges):
        object.__setattr__(self, "ranges", _box(ranges))

    @property
    def n_rvs(self):
        return len(self.ranges)

    def sample(self, generator, n: int = 1):
        device = generator.device
        lo = _f32([r[0] for r in self.ranges], device)
        hi = _f32([r[1] for r in self.ranges], device)
        u = torch.rand((n, self.n_rvs), generator=generator, device=device)
        return lo + u * (hi - lo)

    def grad_log_pdf(self, var):
        return torch.zeros_like(torch.as_tensor(var, dtype=torch.float32))


@dataclass(frozen=True, eq=False)
class MVUniformDistribution(Distribution):
    """Uniform over the simplex {x ≥ 0 : Σx = 1} of dimension ``dim``: a
    Dirichlet(1, …, 1) draw, Gamma(1) draws over their sum."""

    dim: int = 6

    @property
    def n_rvs(self):
        return self.dim

    def sample(self, generator, n: int = 1):
        g = _gamma(generator, 1.0, (n, self.dim))
        return g / torch.sum(g, dim=1, keepdim=True)


@dataclass(frozen=True, eq=False)
class DiscreteUniformDistribution(Distribution):
    """Uniform over the integers [0, 2^num_bits), as an f32 column."""

    num_bits: int = 1

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        z = torch.randint(0, 2 ** self.num_bits, (n, 1), generator=generator,
                          device=generator.device)
        return z.to(torch.float32)


@dataclass(frozen=True, eq=False)
class ConstantDistribution(Distribution):
    """Dirac delta at ``values``."""

    values: Tuple[float, ...]

    def __init__(self, values):
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
        object.__setattr__(self, "values", tuple(map(float, arr)))

    @property
    def n_rvs(self):
        return len(self.values)

    def sample(self, generator, n: int = 1):
        v = _f32(self.values, generator.device)
        return v[None, :].expand(n, self.n_rvs).clone()


def _normal_cdf(z):
    """Φ(z) in f64 on the host (erfc keeps the lower tail's precision)."""
    return 0.5 * math.erfc(-z / math.sqrt(2.0))


@dataclass(frozen=True, eq=False)
class NormalDistribution(Distribution):
    """Scalar normal N(mean, var); with ``trunc`` = (lo, hi), truncated to
    it by the inverse CDF of a uniform draw between Φ(lo) and Φ(hi) (in
    f64, then rounded to f32)."""

    mean: float = 0.0
    var: float = 1.0
    trunc: Tuple[float, float] | None = None

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        std = float(np.sqrt(self.var))
        device = generator.device
        if self.trunc is None:
            z = torch.randn((n, 1), generator=generator, device=device)
            return self.mean + std * z
        lo = (self.trunc[0] - self.mean) / std
        hi = (self.trunc[1] - self.mean) / std
        c_lo, c_hi = _normal_cdf(lo), _normal_cdf(hi)
        u = torch.rand((n, 1), generator=generator, device=device,
                       dtype=torch.float64)
        z = torch.clamp(torch.special.ndtri(c_lo + u * (c_hi - c_lo)), lo, hi)
        return (self.mean + std * z).to(torch.float32)

    def grad_log_pdf(self, x):
        return -(torch.as_tensor(x, dtype=torch.float32) - self.mean) / self.var


@dataclass(frozen=True, eq=False)
class MultivariateNormalDistribution(Distribution):
    """MVN(mean, cov), drawn as mean + z·Fᵀ with F = V·√Λ from the
    eigendecomposition of ``cov`` (the JAX package's ``method="eigh"``;
    the factor is taken on the host in f64)."""

    mean: Tuple[float, ...]
    cov: Tuple[Tuple[float, ...], ...]

    def __init__(self, mean, cov):
        mean = np.atleast_1d(np.asarray(mean, np.float64))
        cov = np.atleast_2d(np.asarray(cov, np.float64))
        object.__setattr__(self, "mean", tuple(map(float, mean)))
        object.__setattr__(
            self, "cov", tuple(tuple(map(float, row)) for row in cov))

    @property
    def n_rvs(self):
        return len(self.mean)

    def sample(self, generator, n: int = 1):
        device = generator.device
        vals, vecs = np.linalg.eigh(np.asarray(self.cov))
        factor = vecs * np.sqrt(np.clip(vals, 0.0, None))[None, :]
        z = torch.randn((n, self.n_rvs), generator=generator, device=device)
        return _f32(self.mean, device) + z @ _f32(factor.T.tolist(), device)

    def grad_log_pdf(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        prec = _f32(np.linalg.inv(np.asarray(self.cov)).tolist(), x.device)
        return -(x - _f32(self.mean, x.device)) @ prec.T


@dataclass(frozen=True, eq=False)
class SlantedNormalDistribution(Distribution):
    """x = U(ranges) + weight · N(0, 1) per axis."""

    ranges: Tuple[Tuple[float, float], ...]
    weight: float = 0.01

    def __init__(self, ranges=((0.0, 1.0),), weight=0.01):
        object.__setattr__(self, "ranges", _box(ranges))
        object.__setattr__(self, "weight", float(weight))

    @property
    def n_rvs(self):
        return len(self.ranges)

    def sample(self, generator, n: int = 1):
        u = UniformDistribution(self.ranges).sample(generator, n)
        z = torch.randn((n, self.n_rvs), generator=generator,
                        device=generator.device)
        return u + self.weight * z


@dataclass(frozen=True, eq=False)
class LogNormalDistribution(Distribution):
    """LogNormal(mu, sigma): exp(mu + sigma · N(0, 1))."""

    mu: float = 0.0
    sigma: float = 1.0

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        z = torch.randn((n, 1), generator=generator, device=generator.device)
        return torch.exp(self.mu + self.sigma * z)


def _shape_params(alpha, beta, mean, var, moments, name):
    """(alpha, beta) given directly or from (mean, var) by ``moments``."""
    if alpha is not None and beta is not None:
        return float(alpha), float(beta)
    if mean is not None and var is not None:
        return moments(mean, var)
    raise ValueError(f"{name} requires either (alpha, beta) or (mean, var).")


@dataclass(frozen=True, eq=False)
class BetaDistribution(Distribution):
    """Beta(alpha, beta), or from (mean, var); drawn as X / (X + Y) of two
    Gamma draws."""

    alpha: float
    beta: float

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        a, b = _shape_params(
            alpha, beta, mean, var,
            lambda m, v: (m ** 2 * (1 - m) / v - m,
                          (m * (1 - m) / v - 1) * (1 - m)),
            "BetaDistribution")
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        x = _gamma(generator, self.alpha, (n, 1))
        y = _gamma(generator, self.beta, (n, 1))
        return x / (x + y)


@dataclass(frozen=True, eq=False)
class BetaBinomialDistribution(Distribution):
    """Beta-binomial counts over {0 … n}, or from (mean, var): a binomial
    draw at a Beta-drawn probability."""

    n: int
    alpha: float
    beta: float

    def __init__(self, n, alpha=None, beta=None, mean=None, var=None):
        n = int(n)

        def moments(m, v):
            den = n * (v / m - 1) + m
            return ((n * m - m ** 2 - v) / den,
                    (n - m) * (n - m ** 2 / m - v / m) / den)

        a, b = _shape_params(alpha, beta, mean, var, moments,
                             "BetaBinomialDistribution")
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        p = BetaDistribution(self.alpha, self.beta).sample(generator, n)
        count = torch.full_like(p, float(self.n))
        return binomial(count, p, generator)


@dataclass(frozen=True, eq=False)
class GammaDistribution(Distribution):
    """Gamma(alpha, beta) (shape, rate), or from (mean, var)."""

    alpha: float
    beta: float

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        a, b = _shape_params(alpha, beta, mean, var,
                             lambda m, v: (m ** 2 / v, m / v),
                             "GammaDistribution")
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        return _gamma(generator, self.alpha, (n, 1)) / self.beta


@dataclass(frozen=True, eq=False)
class ProductDistribution(Distribution):
    """Independent factors side by side, each drawn in turn."""

    factors: Tuple[Distribution, ...]

    def __init__(self, *factors):
        if len(factors) == 1 and isinstance(factors[0], (list, tuple)):
            factors = tuple(factors[0])
        object.__setattr__(self, "factors", tuple(factors))

    @property
    def n_rvs(self):
        return sum(f.n_rvs for f in self.factors)

    def sample(self, generator, n: int = 1):
        return torch.cat([f.sample(generator, n) for f in self.factors], dim=1)


@dataclass(frozen=True, eq=False)
class MixtureDistribution(Distribution):
    """Mixture Σ wᵢ Dᵢ of components with equal n_rvs (``dist`` a sequence
    of distributions, or a class built once per weight from ``dist_args``
    and ``dist_kw_args``). Each row's component is the inverse CDF of a
    uniform draw over the weights; every component draws n rows and each
    row keeps its component's."""

    weights: Tuple[float, ...]
    dist: Tuple[Distribution, ...]

    def __init__(self, weights, dist, dist_args=None, dist_kw_args=None,
                 shuffle=True):
        weights = tuple(float(w) for w in np.atleast_1d(weights))
        if callable(dist):
            dist_args = np.asarray(dist_args)
            dist = tuple(
                dist(*np.atleast_1d(dist_args[i]),
                     **({k: v[i] for k, v in dist_kw_args.items()}
                        if dist_kw_args else {}))
                for i in range(len(weights)))
        else:
            dist = tuple(dist)
        total = sum(weights)
        object.__setattr__(self, "weights", tuple(w / total for w in weights))
        object.__setattr__(self, "dist", dist)

    @property
    def n_rvs(self):
        return self.dist[0].n_rvs

    def sample(self, generator, n: int = 1):
        device = generator.device
        cdf = _f32(np.cumsum(self.weights).tolist(), device)
        u = torch.rand(n, generator=generator, device=device)
        comp = torch.clamp(torch.searchsorted(cdf, u, right=True),
                           max=len(self.dist) - 1)
        stacked = torch.stack([d.sample(generator, n) for d in self.dist])
        return stacked[comp, torch.arange(n, device=device)]


@dataclass(frozen=True, eq=False)
class PostselectedDistribution(Distribution):
    """Samples of ``dist`` that ``model.are_models_valid`` accepts: the
    invalid rows are redrawn for ``maxiters`` rounds, and what is still
    invalid is clamped by ``model.canonicalize``. The rounds run without a
    host read."""

    dist: Distribution
    model: object
    maxiters: int = 100

    @property
    def n_rvs(self):
        return self.dist.n_rvs

    def sample(self, generator, n: int = 1):
        samples = self.dist.sample(generator, n)
        ok = self.model.are_models_valid(samples)
        for _ in range(self.maxiters):
            fresh = self.dist.sample(generator, n)
            valid = self.model.are_models_valid(fresh)
            samples = torch.where((~ok & valid)[:, None], fresh, samples)
            ok = ok | valid
        if hasattr(self.model, "canonicalize"):
            samples = torch.where(ok[:, None], samples,
                                  self.model.canonicalize(samples))
        return samples


@dataclass(frozen=True, eq=False)
class ConstrainedSumDistribution(Distribution):
    """Draws of ``underlying_distribution`` rescaled so that each row sums
    to ``desired_total``."""

    underlying_distribution: Distribution
    desired_total: float = 1.0

    @property
    def n_rvs(self):
        return self.underlying_distribution.n_rvs

    def sample(self, generator, n: int = 1):
        s = self.underlying_distribution.sample(generator, n)
        return self.desired_total * s / torch.sum(s, dim=1, keepdim=True)


@dataclass(frozen=True, eq=False)
class InterpolatedUnivariateDistribution(Distribution):
    """A univariate ``pdf`` sampled by the inverse of its CDF: the CDF is
    a trapezoid sum over a compactified grid (``compactspace``), built on
    the host at construction from ``pdf`` at each grid point, and a
    uniform draw is mapped through it by linear interpolation (as
    ``numpy.interp``)."""

    pdf: Callable = field(compare=False)
    compactification_scale: float = 1.0
    n_interp_points: int = 1500

    def __post_init__(self):
        xs = compactspace(self.compactification_scale, self.n_interp_points)
        ps = np.maximum(np.asarray([self.pdf(x) for x in xs], np.float64),
                        0.0)
        mass = 0.5 * (ps[1:] + ps[:-1]) * np.diff(xs)
        cdf = np.concatenate([[0.0], np.cumsum(mass)])
        cdf /= cdf[-1]
        object.__setattr__(self, "_xs", torch.tensor(xs, dtype=torch.float32))
        object.__setattr__(self, "_cdf",
                           torch.tensor(cdf, dtype=torch.float32))

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n: int = 1):
        device = generator.device
        xs, cdf = self._xs.to(device), self._cdf.to(device)
        u = torch.rand(n, generator=generator, device=device)
        i = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0,
                        cdf.shape[0] - 2)
        dc = cdf[i + 1] - cdf[i]
        frac = torch.where(dc > 0, (u - cdf[i]) / torch.where(dc > 0, dc, 1.0),
                           0.0)
        return (xs[i] + torch.clamp(frac, 0.0, 1.0) * (xs[i + 1] - xs[i]))[
            :, None]


class ParticleDistribution(Distribution):
    """A weighted particle cloud ``(particle_locations,
    particle_log_weights)`` with moment helpers."""

    def __init__(self, particle_locations, particle_weights=None,
                 log_weights=None):
        self.particle_locations = torch.as_tensor(particle_locations,
                                                  dtype=torch.float32)
        n = self.particle_locations.shape[0]
        device = self.particle_locations.device
        if log_weights is not None:
            self.particle_log_weights = torch.as_tensor(
                log_weights, dtype=torch.float32, device=device)
        elif particle_weights is not None:
            self.particle_log_weights = torch.log(torch.as_tensor(
                particle_weights, dtype=torch.float32, device=device))
        else:
            self.particle_log_weights = torch.full(
                (n,), -float(np.log(n)), dtype=torch.float32, device=device)

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def particle_weights(self):
        return torch.exp(normalize_log_weights(self.particle_log_weights)[0])

    def sample(self, generator, n: int = 1):
        idx = torch.multinomial(self.particle_weights, n, replacement=True,
                                generator=generator)
        return self.particle_locations[idx]

    def est_mean(self):
        return particle_mean(self.particle_weights, self.particle_locations)

    def est_covariance_mtx(self, corr=False):
        cov = particle_covariance_mtx(self.particle_weights,
                                      self.particle_locations)
        if corr:
            std = torch.sqrt(torch.diag(cov))
            cov = cov / torch.outer(std, std)
        return cov

    @property
    def n_ess(self):
        """ESS = 1/Σwᵢ² (a property, as in the reference)."""
        return effective_sample_size(self.particle_log_weights)
