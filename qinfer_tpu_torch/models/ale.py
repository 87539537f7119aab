"""Adaptive likelihood estimation. Counterpart of ``qinfer_tpu/models/ale.py``:
``ALEApproximateModel``, ``binom_est_p`` and ``binom_est_error``.

``ALEApproximateModel`` estimates Pr(outcome) of every (particle,
experiment) cell from the frequencies of its simulator's draws, in batches
of ``samp_step`` draws after the first ``min_samp``, until the worst-case
standard error is at most ``error_tol`` or ``max_samp`` draws are taken.
The JAX package's ``lax.while_loop`` becomes a host loop that reads the
worst-case error once per batch (up to 127 reads a call with the
defaults) and stops at the same batch. Each batch is counted as it is
drawn, so no (draws, N, E, O) one-hot is ever held. Every call draws from
a fresh ``torch.Generator`` seeded ``seed`` on the bank's device, so
identical calls see identical draws, as the JAX package's
``PRNGKey(seed)`` makes them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import Model

__all__ = ["ALEApproximateModel", "binom_est_p", "binom_est_error"]


def binom_est_p(n, N, hedge=0.0):
    """Hedged binomial point estimate (n + h)/(N + 2h)."""
    return (n + hedge) / (N + 2 * hedge)


def binom_est_error(p, N, hedge=0.0):
    """Standard error of the hedged estimator."""
    return torch.sqrt(torch.as_tensor(p * (1 - p) / (N + 2 * hedge + 1)))


@dataclass(frozen=True, eq=False)
class ALEApproximateModel(Model):
    """Likelihood from simulation frequencies of ``simulator`` (which needs
    only ``simulate_experiment``, ``n_outcomes`` and ``are_models_valid``).
    ``last_n_samples`` is the number of draws per cell of the last
    likelihood call."""

    simulator: object = None
    error_tol: float = 1e-2
    min_samp: int = 16
    samp_step: int = 16
    est_hedge: float = 0.509
    max_samp: int = 2048
    seed: int = 0

    @property
    def n_modelparams(self):
        return self.simulator.n_modelparams

    @property
    def modelparam_names(self):
        return self.simulator.modelparam_names

    @property
    def expparams_dtype(self):
        return self.simulator.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.simulator.n_outcomes(expparams)

    def are_models_valid(self, modelparams):
        return self.simulator.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.simulator.canonicalize(modelparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.simulator.simulate_experiment(generator, modelparams,
                                                  expparams, repeat)

    @property
    def last_n_samples(self):
        return self.__dict__.get("_last_n_samples")

    def _counts(self, generator, modelparams, expparams, n_draws, n_out):
        """(N, E, O) f32 counts of each outcome in n_draws draws."""
        sims = self.simulator.simulate_experiment(
            generator, modelparams, expparams, repeat=n_draws)  # (R, N, E)
        return torch.stack([(sims == o).sum(0) for o in range(n_out)],
                           dim=-1).to(torch.float32)

    def likelihood(self, outcomes, modelparams, expparams):
        device = modelparams.device
        outcomes = torch.as_tensor(outcomes, device=device).to(
            torch.int64).reshape(-1)
        n_out = self.n_outcomes(expparams)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        counts = self._counts(generator, modelparams, expparams,
                              self.min_samp, n_out)
        total = self.min_samp
        while total < self.max_samp:
            p = binom_est_p(counts, float(total), self.est_hedge)
            err = binom_est_error(p, float(total), self.est_hedge)
            if not bool(torch.max(err) > self.error_tol):  # one read a batch
                break
            counts = counts + self._counts(generator, modelparams, expparams,
                                           self.samp_step, n_out)
            total += self.samp_step
        object.__setattr__(self, "_last_n_samples", total)
        p_est = binom_est_p(counts, float(total), self.est_hedge)  # (N, E, O)
        return torch.movedim(p_est[:, :, outcomes], -1, 0)  # (O_req, N, E)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return torch.log(torch.clamp(
            self.likelihood(outcomes, modelparams, expparams), min=1e-38))
