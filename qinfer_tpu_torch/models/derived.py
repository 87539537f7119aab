"""Model combinators. Counterpart of ``qinfer_tpu/models/derived.py``:
``DerivedModel``, ``BinomialModel``, the ``DifferentiableBinomialModel``
alias, ``MultinomialModel``, ``PoisonedModel``, ``RandomWalkModel``,
``GaussianRandomWalkModel``, ``MLEModel`` and ``ReferencedPoissonModel``.

Only ``BinomialModel`` has a tile in kernel B1 (its underlying model's);
the other combinators are ``Model``s without ``fused_update_supported``,
so the SMC step updates them unfused, as the JAX step does. The random
walks diffuse the bank in ``update_timestep`` with draws from the
``torch.Generator`` it is given (the state's, in the SMC step).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..domains import IntegerDomain, MultinomialDomain
from ..utils import (
    binomial,
    log_binomial_coefficient,
    log_binomial_pdf,
    poisson,
    sample_multinomial,
)
from .base import (
    FiniteOutcomeModel,
    Model,
    _column,
    _expparams_device,
    _expparams_row,
    _n_exps,
    expparams_field,
)

__all__ = ["DerivedModel", "BinomialModel", "DifferentiableBinomialModel",
           "MultinomialModel", "PoisonedModel", "RandomWalkModel",
           "GaussianRandomWalkModel", "MLEModel", "ReferencedPoissonModel"]


@dataclass(frozen=True, eq=False)
class DerivedModel(Model):
    """Base combinator delegating metadata to ``underlying_model``."""

    underlying_model: Model = None

    @property
    def base_model(self):
        return self.underlying_model.base_model

    @property
    def model_chain(self):
        return self.underlying_model.model_chain + (self.underlying_model,)

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams

    @property
    def modelparam_names(self):
        return self.underlying_model.modelparam_names

    @property
    def expparams_dtype(self):
        return self.underlying_model.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.underlying_model.n_outcomes(expparams)

    def are_models_valid(self, modelparams):
        return self.underlying_model.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.underlying_model.canonicalize(modelparams)

    def redraw_round(self, device):
        # The underlying model's round tests what its are_models_valid
        # tests: a model that tests more keeps the masked chain.
        if type(self).are_models_valid is not DerivedModel.are_models_valid:
            return None
        return self.underlying_model.redraw_round(device)

    def update_timestep(self, modelparams, expparams, generator=None):
        return self.underlying_model.update_timestep(
            modelparams, expparams, generator=generator)

    @property
    def Q(self):
        return self.underlying_model.Q


def _max_n_meas(expparams):
    """max(n_meas) as a Python int (one host read)."""
    return int(torch.as_tensor(expparams_field(expparams, "n_meas")).max())


def _with_field(base, name, kind):
    """The underlying expparams dtype with one field appended."""
    base = base if isinstance(base, list) else [("x", base)]
    return base + [(name, kind)]


@dataclass(frozen=True, eq=False)
class BinomialModel(DerivedModel):
    """``n_meas`` repetitions of a two-outcome model; the outcome is the
    count of '1' results. expparams gain the ('n_meas', 'uint') field."""

    @property
    def expparams_dtype(self):
        return _with_field(self.underlying_model.expparams_dtype, "n_meas",
                           "uint")

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        """max(n_meas) + 1 (reads ``n_meas`` on the host)."""
        if expparams is None:
            raise ValueError("BinomialModel.n_outcomes requires expparams.")
        return _max_n_meas(expparams) + 1

    def log_likelihood(self, outcomes, modelparams, expparams):
        n_meas = _column(expparams, "n_meas", modelparams.device)  # (E,)
        p1 = 1.0 - self.underlying_model.pr0(modelparams, expparams)
        k = torch.as_tensor(outcomes, device=modelparams.device).to(
            torch.float32).reshape(-1)  # (O,)
        return log_binomial_pdf(n_meas[None, None, :], k[:, None, None],
                                p1[None, :, :])

    @property
    def fused_update_supported(self):
        return getattr(self.underlying_model, "fused_update_supported", False)

    def fused_spec(self, outcome, modelparams, expparams):
        """The binomial tile over the underlying model's pr1 function;
        scalars = [k, n_meas, log C(n_meas, k), *pr1_scalars], all on the
        device (log C by lgamma there: no host sync)."""
        from ..ops.fused_update import binomial_tile

        pr1_fn, tail, cols = self.underlying_model._pr1_parts_or_raise(
            modelparams, expparams)
        dev = modelparams.device
        n = _column(expparams, "n_meas", dev)[:1]
        k = torch.as_tensor(outcome, device=dev).to(torch.float32).reshape(1)
        scalars = torch.cat([k, n, log_binomial_coefficient(n, k),
                             tail.to(torch.float32)])
        return binomial_tile(pr1_fn), scalars, cols

    # The one-bank fused update over this class's ``fused_spec``: the
    # underlying two-outcome model's pr1 inside the binomial log-pmf.
    fused_update = FiniteOutcomeModel.fused_update

    def fused_spec_batched(self, outcomes, modelparams, expparams):
        """The binomial tile for T banks (T, N, D), trial i seeing count
        ``outcomes[i]`` of experiment i: scalars (T, 3 + k) = [k, n_meas,
        log C(n_meas, k), *pr1_scalars] per trial, on the device."""
        from ..ops.fused_update import binomial_tile

        pr1_fn, tail, cols = self.underlying_model._batched_pr1_parts(
            modelparams, expparams)
        dev = modelparams.device
        n_trials = modelparams.shape[0]
        n = _column(expparams, "n_meas", dev)
        k = torch.as_tensor(outcomes, device=dev).to(torch.float32).reshape(-1)
        scalars = torch.cat([torch.stack([k, n, log_binomial_coefficient(n, k)],
                                         dim=1),
                             tail.to(torch.float32).reshape(n_trials, -1)],
                            dim=1)
        return binomial_tile(pr1_fn), scalars, cols

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Counts of '1' in ``n_meas`` shots, (repeat, N, E) int32, drawn
        binomially over the underlying model's Pr(1)."""
        self._bump_sim_count(modelparams, expparams, repeat)
        n_meas = _column(expparams, "n_meas", modelparams.device)
        p1 = torch.clamp(
            1.0 - self.underlying_model.pr0(modelparams, expparams), 0.0, 1.0)
        shape = (repeat,) + tuple(p1.shape)
        return binomial(n_meas.expand(shape).contiguous(),
                        p1.expand(shape).contiguous(), generator).to(
                            torch.int32)

    def simulate_trials(self, generator, modelparams, expparams):
        """One count per trial at its own parameters and experiment: a
        binomial draw over the underlying pr1 tile when it has one."""
        under = self.underlying_model
        if not getattr(under, "fused_update_supported", False):
            return super().simulate_trials(generator, modelparams, expparams)
        self._bump_sim_count(modelparams, _expparams_row(expparams, 0))
        p1 = under._trial_pr1(modelparams, expparams)
        n_meas = _column(expparams, "n_meas", modelparams.device)
        return binomial(n_meas, p1, generator).to(torch.int32)


class DifferentiableBinomialModel(BinomialModel):
    """Alias kept for API parity with the JAX package."""


@dataclass(frozen=True, eq=False)
class MultinomialModel(DerivedModel):
    """``n_meas`` repetitions of a k-outcome model; an outcome is the (k,)
    vector of the count of each side (``outcome_ndim`` 1), over
    ``MultinomialDomain``. expparams gain the ('n_meas', 'uint') field."""

    @property
    def expparams_dtype(self):
        return _with_field(self.underlying_model.expparams_dtype, "n_meas",
                           "uint")

    @property
    def is_n_outcomes_constant(self):
        return False

    @property
    def outcome_ndim(self):
        return 1

    @property
    def n_sides(self):
        return self.underlying_model.n_outcomes(None)

    def n_outcomes(self, expparams=None):
        """C(max(n_meas) + k − 1, k − 1) (reads ``n_meas`` on the host)."""
        return math.comb(_max_n_meas(expparams) + self.n_sides - 1,
                         self.n_sides - 1)

    def domain(self, expparams=None):
        return MultinomialDomain(n_meas=_max_n_meas(expparams),
                                 n_elements=self.n_sides)

    def all_outcomes(self, expparams=None):
        """Every count vector of the domain, (O, k) int32, on the device of
        ``expparams``."""
        return self.domain(expparams).values.to(_expparams_device(expparams))

    def _side_log_likelihood(self, modelparams, expparams):
        sides = torch.arange(self.n_sides, dtype=torch.int32,
                             device=modelparams.device)
        return self.underlying_model.log_likelihood(sides, modelparams,
                                                    expparams)  # (k, N, E)

    def log_likelihood(self, outcomes, modelparams, expparams):
        """log n! − Σ log k_i! + Σ k_i log p_i, (O, N, E)."""
        log_p = self._side_log_likelihood(modelparams, expparams)
        ks = torch.as_tensor(outcomes, device=modelparams.device).to(
            torch.float32).reshape(-1, self.n_sides)
        n = torch.sum(ks, dim=-1)
        const = torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(ks + 1.0),
                                                  dim=-1)
        return const[:, None, None] + torch.einsum("ok,kne->one", ks, log_p)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Count vectors (repeat, N, E, k) int32 by ``sample_multinomial``
        over the underlying model's side probabilities."""
        self._bump_sim_count(modelparams, expparams, repeat)
        p = torch.exp(self._side_log_likelihood(modelparams, expparams))
        n_meas = _column(expparams, "n_meas", modelparams.device)
        shape = (repeat,) + tuple(p.shape[1:])
        return sample_multinomial(generator, n_meas,
                                  torch.movedim(p, 0, -1)[None], shape=shape)


def _int32(x):
    """x as a signed 32-bit integer (two's complement wrap-around)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


@dataclass(frozen=True, eq=False)
class PoisonedModel(DerivedModel):
    """Fault injection: the underlying likelihood perturbed by noise.

    - ALE mode (``tol`` set): additive N(0, tol²) noise on each likelihood.
    - MLE mode (``n_samples`` set): L replaced by the hedged binomial
      estimate (k + hedge)/(n_samples + 2·hedge) of n_samples draws.

    The result is clipped to [0, 1]. The noise comes from a
    ``torch.Generator`` seeded from ``seed`` and the experiment (the JAX
    package's XOR of the sums of the f32 bit patterns of the expparams
    leaves, ``noise_mix``), so repeated identical calls see identical
    noise; reading the expparams for it is one host read a call.
    ``simulate_experiment`` is not poisoned.
    """

    tol: Optional[float] = None
    n_samples: Optional[int] = None
    hedge: float = 0.0
    seed: int = 0

    @staticmethod
    def noise_mix(expparams):
        """XOR over the expparams leaves of the int32 sum of each leaf's f32
        bit patterns (the value the JAX package folds into its key)."""
        leaves = expparams.values() if isinstance(expparams, dict) else (
            expparams,)
        mix = 0
        for leaf in leaves:
            f32 = np.asarray(torch.as_tensor(leaf).to(torch.float32).cpu(),
                             dtype=np.float32)
            mix ^= _int32(int(f32.view(np.int32).astype(np.int64).sum()))
        return mix

    def _noise_generator(self, expparams, device):
        seed = ((self.seed & 0xFFFFFFFF) << 32) | (
            self.noise_mix(expparams) & 0xFFFFFFFF)
        return torch.Generator(device=device).manual_seed(seed)

    def likelihood(self, outcomes, modelparams, expparams):
        L = self.underlying_model.likelihood(outcomes, modelparams, expparams)
        g = self._noise_generator(expparams, L.device)
        if self.tol is not None:
            eps = self.tol * torch.randn(L.shape, generator=g, device=L.device)
        else:
            n = self.n_samples if self.n_samples else 1
            draws = torch.binomial(torch.full_like(L, float(n)),
                                   torch.clamp(L, 0.0, 1.0), generator=g)
            eps = (draws + self.hedge) / (n + 2 * self.hedge) - L
        return torch.clamp(L + eps, 0.0, 1.0)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return torch.log(torch.clamp(
            self.likelihood(outcomes, modelparams, expparams), min=1e-38))

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        self._bump_sim_count(modelparams, expparams, repeat)
        return self.underlying_model.simulate_experiment(
            generator, modelparams, expparams, repeat)


@dataclass(frozen=True, eq=False)
class RandomWalkModel(DerivedModel):
    """The underlying model, with each parameter row moved after every
    experiment by a draw of ``step_distribution``."""

    step_distribution: object = None

    def likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.likelihood(outcomes, modelparams,
                                                expparams)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.log_likelihood(outcomes, modelparams,
                                                    expparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.underlying_model.simulate_experiment(
            generator, modelparams, expparams, repeat)

    def pr0(self, modelparams, expparams):
        return self.underlying_model.pr0(modelparams, expparams)

    def update_timestep(self, modelparams, expparams, generator=None):
        """(N, D, E): row i plus its own step for each experiment, N·E
        rows drawn from ``step_distribution`` on ``generator`` (a fresh one
        seeded 0 on the bank's device when None)."""
        if generator is None:
            generator = torch.Generator(
                device=modelparams.device).manual_seed(0)
        n, d = modelparams.shape
        n_exp = _n_exps(expparams)
        steps = self.step_distribution.sample(generator, n * n_exp).reshape(
            n, n_exp, d)
        return (modelparams[:, None, :] + steps).transpose(1, 2)


@dataclass(frozen=True, eq=False)
class GaussianRandomWalkModel(DerivedModel):
    """A random walk with learned Gaussian step scales: the model vector
    gains σ (one per base parameter when ``diagonal``, else one shared),
    σ ≥ 0, and each timestep moves the base parameters of row i by
    N(0, σ_i²)."""

    diagonal: bool = True

    @property
    def _n_sigma(self):
        return self.underlying_model.n_modelparams if self.diagonal else 1

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + self._n_sigma

    @property
    def modelparam_names(self):
        base = tuple(self.underlying_model.modelparam_names)
        if self.diagonal:
            return base + tuple(f"sigma_{name}" for name in base)
        return base + ("sigma",)

    def _split(self, modelparams):
        d = self.underlying_model.n_modelparams
        return modelparams[:, :d], modelparams[:, d:]

    def are_models_valid(self, modelparams):
        base, sigma = self._split(modelparams)
        return self.underlying_model.are_models_valid(base) & torch.all(
            sigma >= 0, dim=-1)

    def canonicalize(self, modelparams):
        base, sigma = self._split(modelparams)
        return torch.cat([self.underlying_model.canonicalize(base),
                          torch.clamp(sigma, min=0.0)], dim=1)

    def log_likelihood(self, outcomes, modelparams, expparams):
        base, _ = self._split(modelparams)
        return self.underlying_model.log_likelihood(outcomes, base, expparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        base, _ = self._split(modelparams)
        return self.underlying_model.simulate_experiment(
            generator, base, expparams, repeat)

    def update_timestep(self, modelparams, expparams, generator=None):
        """(N, D, E): the base parameters moved by σ-scaled normals (N, d,
        E) from ``generator`` (a fresh one seeded 0 on the bank's device
        when None); σ kept."""
        if generator is None:
            generator = torch.Generator(
                device=modelparams.device).manual_seed(0)
        base, sigma = self._split(modelparams)
        n, d = base.shape
        n_exp = _n_exps(expparams)
        eps = torch.randn((n, d, n_exp), generator=generator,
                          device=modelparams.device)
        scale = sigma if self.diagonal else sigma.expand(n, d)
        walked = base[:, :, None] + scale[:, :, None] * eps
        kept = sigma[:, :, None].expand(sigma.shape + (n_exp,))
        return torch.cat([walked, kept], dim=1)


@dataclass(frozen=True, eq=False)
class MLEModel(DerivedModel):
    """Likelihood annealing: L → L^likelihood_power, which concentrates the
    posterior on the maximum-likelihood estimate."""

    likelihood_power: float = 1.0

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self.likelihood_power * self.underlying_model.log_likelihood(
            outcomes, modelparams, expparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.underlying_model.simulate_experiment(
            generator, modelparams, expparams, repeat)


@dataclass(frozen=True, eq=False)
class ReferencedPoissonModel(DerivedModel):
    """Poisson counts referenced to bright and dark calibrations. The
    underlying two-outcome model gives p = Pr(1); the model vector gains
    the bright and dark rates (α, β), valid for α ≥ β ≥ 0. expparams gain
    'mode': ``SIGNAL`` (rate p·α + (1 − p)·β), ``BRIGHT`` (α) or ``DARK``
    (β).

    ``max_rate`` bounds every rate and so the enumeration of outcomes
    (``all_outcomes``, the design functions): λ + 10√λ + 10, past which
    the Poisson tail holds below ~1e-12; without it the enumeration stops
    at 1000 outcomes, enough for rates up to ~900."""

    SIGNAL = 0
    BRIGHT = 1
    DARK = 2

    max_rate: Optional[float] = None

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + 2

    @property
    def modelparam_names(self):
        return tuple(self.underlying_model.modelparam_names) + ("alpha",
                                                                "beta")

    @property
    def expparams_dtype(self):
        return _with_field(self.underlying_model.expparams_dtype, "mode",
                           "int")

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        if self.max_rate is not None:
            lam = float(self.max_rate)
            return int(math.ceil(lam + 10.0 * math.sqrt(lam) + 10.0)) + 1
        return 1000

    def domain(self, expparams=None):
        return IntegerDomain(min=0, max=None)

    @property
    def Q(self):
        """Unit loss weights over all n_modelparams, the rates included.
        (The JAX package's delegates to the underlying model's, two
        short, and its ``bayes_risk`` then fails without an explicit Q.)"""
        return torch.ones(self.n_modelparams, dtype=torch.float32)

    def _split(self, modelparams):
        d = self.underlying_model.n_modelparams
        return modelparams[:, :d], modelparams[:, d], modelparams[:, d + 1]

    def are_models_valid(self, modelparams):
        base, alpha, beta = self._split(modelparams)
        return (self.underlying_model.are_models_valid(base) & (alpha >= 0)
                & (beta >= 0) & (alpha >= beta))

    def canonicalize(self, modelparams):
        base, alpha, beta = self._split(modelparams)
        beta = torch.clamp(beta, min=0.0)
        alpha = torch.maximum(torch.clamp(alpha, min=0.0), beta)
        return torch.cat([self.underlying_model.canonicalize(base),
                          alpha[:, None], beta[:, None]], dim=1)

    def _rate(self, modelparams, expparams):
        """The Poisson rate of each particle and experiment, (N, E)."""
        base, alpha, beta = self._split(modelparams)
        mode = torch.as_tensor(expparams_field(expparams, "mode"),
                               device=modelparams.device).reshape(-1)
        p = 1.0 - self.underlying_model.pr0(base, expparams)
        signal = p * alpha[:, None] + (1.0 - p) * beta[:, None]
        fixed = torch.where(mode[None, :] == self.BRIGHT, alpha[:, None],
                            beta[:, None])
        return torch.where(mode[None, :] == self.SIGNAL, signal, fixed)

    def log_likelihood(self, outcomes, modelparams, expparams):
        rate = torch.clamp(self._rate(modelparams, expparams), min=1e-10)
        k = torch.as_tensor(outcomes, device=modelparams.device).to(
            torch.float32).reshape(-1)
        return (k[:, None, None] * torch.log(rate)[None] - rate[None]
                - torch.lgamma(k + 1.0)[:, None, None])

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Counts (repeat, N, E) int32 drawn by ``torch.poisson``
        (``utils.poisson``)."""
        self._bump_sim_count(modelparams, expparams, repeat)
        rate = self._rate(modelparams, expparams)
        rates = rate[None].expand((repeat,) + tuple(rate.shape)).contiguous()
        return poisson(rates, generator).to(torch.int32)
