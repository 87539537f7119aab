"""Model combinators. Counterpart of ``qinfer_tpu/models/derived.py``:
``DerivedModel``, ``BinomialModel``, the ``DifferentiableBinomialModel``
alias and ``PoisonedModel``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import log_binomial_coefficient, log_binomial_pdf
from .base import Model, _column, _expparams_row, expparams_field

__all__ = ["DerivedModel", "BinomialModel", "DifferentiableBinomialModel",
           "PoisonedModel"]


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

    def update_timestep(self, modelparams, expparams, generator=None):
        return self.underlying_model.update_timestep(
            modelparams, expparams, generator=generator)

    @property
    def Q(self):
        return self.underlying_model.Q


@dataclass(frozen=True, eq=False)
class BinomialModel(DerivedModel):
    """``n_meas`` repetitions of a two-outcome model; the outcome is the
    count of '1' results. expparams gain the ('n_meas', 'uint') field."""

    @property
    def expparams_dtype(self):
        base = self.underlying_model.expparams_dtype
        base = base if isinstance(base, list) else [("x", base)]
        return base + [("n_meas", "uint")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        """max(n_meas) + 1 (reads ``n_meas`` on the host)."""
        if expparams is None:
            raise ValueError("BinomialModel.n_outcomes requires expparams.")
        n_meas = torch.as_tensor(expparams_field(expparams, "n_meas"))
        return int(n_meas.max()) + 1

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

    def fused_update(self, outcome, log_w, modelparams, expparams,
                     return_stats=False):
        """Fused binomial update: the underlying two-outcome model's pr1
        function inside the binomial log-pmf, in one pass."""
        from ..ops.fused_update import fused_bayes_update

        tile, scalars, cols = self.fused_spec(outcome, modelparams, expparams)
        return fused_bayes_update(tile, scalars, log_w, cols,
                                  return_stats=return_stats)

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
        return torch.binomial(n_meas.expand(shape).contiguous(),
                              p1.expand(shape).contiguous(),
                              generator=generator).to(torch.int32)

    def simulate_trials(self, generator, modelparams, expparams):
        """One count per trial at its own parameters and experiment: a
        binomial draw over the underlying pr1 tile when it has one."""
        under = self.underlying_model
        if not getattr(under, "fused_update_supported", False):
            return super().simulate_trials(generator, modelparams, expparams)
        self._bump_sim_count(modelparams, _expparams_row(expparams, 0))
        p1 = under._trial_pr1(modelparams, expparams)
        n_meas = _column(expparams, "n_meas", modelparams.device)
        return torch.binomial(n_meas, p1, generator=generator).to(torch.int32)


class DifferentiableBinomialModel(BinomialModel):
    """Alias kept for API parity with the JAX package."""


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
