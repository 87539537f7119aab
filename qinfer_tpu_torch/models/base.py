"""Model DSL on torch tensors.

Counterpart of ``qinfer_tpu/models/base.py``: ``expparams_field``,
``_n_exps``, ``Simulatable``, ``Model`` and ``FiniteOutcomeModel`` with the
fused single-pass update. A model is a frozen dataclass of static metadata
with pure methods; ``log_likelihood`` is the primitive, of shape (O, N, E).
expparams are a tensor (single-field models) or a dict of named tensors
with leading axis E.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Union

import torch

__all__ = [
    "Simulatable", "Model", "FiniteOutcomeModel", "expparams_field",
    "ExpParams",
]

ExpParams = Union[torch.Tensor, Dict[str, torch.Tensor]]


def expparams_field(expparams: ExpParams, name: str):
    """Fetch a named field from expparams; plain tensors are the sole field."""
    if isinstance(expparams, dict):
        return expparams[name]
    return expparams


def _n_exps(expparams: ExpParams) -> int:
    leaf = (
        next(iter(expparams.values()))
        if isinstance(expparams, dict)
        else expparams
    )
    leaf = torch.as_tensor(leaf)
    return leaf.shape[0] if leaf.ndim > 0 else 1


@dataclass(frozen=True, eq=False)
class Simulatable:
    """Base: static metadata, validity, canonicalization and the
    time-dependence hook."""

    @property
    def n_modelparams(self) -> int:
        raise NotImplementedError

    @property
    def modelparam_names(self) -> Sequence[str]:
        return tuple(f"x_{i}" for i in range(self.n_modelparams))

    @property
    def expparams_dtype(self):
        return "float"

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        raise NotImplementedError

    def are_models_valid(self, modelparams):
        """bool[N] validity mask."""
        raise NotImplementedError

    def canonicalize(self, modelparams):
        """Clamp parameters to the valid region (identity by default)."""
        return modelparams

    def update_timestep(self, modelparams, expparams, generator=None):
        """Time-dependence hook: (N, D, E) evolved parameters; identity by
        default. ``generator`` supplies the randomness of stochastic walks."""
        del generator
        n_exp = _n_exps(expparams)
        return modelparams[:, :, None].expand(modelparams.shape + (n_exp,))


@dataclass(frozen=True, eq=False)
class Model(Simulatable):
    """Adds an explicit likelihood."""

    def log_likelihood(self, outcomes, modelparams, expparams):
        """log Pr(outcome | modelparams; expparams), shape (O, N, E)."""
        return torch.log(torch.clamp(
            self.likelihood(outcomes, modelparams, expparams), min=1e-38))

    def likelihood(self, outcomes, modelparams, expparams):
        return torch.exp(self.log_likelihood(outcomes, modelparams, expparams))


@dataclass(frozen=True, eq=False)
class FiniteOutcomeModel(Model):
    """Models with finitely many outcomes; two-outcome models implement
    ``pr0`` of shape (N, E) and get the likelihood and the fused update."""

    def pr0(self, modelparams, expparams):
        raise NotImplementedError

    @staticmethod
    def log_pr0_to_log_likelihood(outcomes, pr0, eps=1e-35):
        """log of the two-outcome likelihood: log(pr0) for outcome 0 and
        log1p(−pr0) otherwise, with pr0 clipped to [eps, 1 − eps]."""
        outcomes = torch.as_tensor(outcomes, device=pr0.device).reshape(-1)
        pr0 = torch.clamp(pr0, eps, 1.0 - eps)
        is_zero = (outcomes == 0)[:, None, None]
        return torch.where(
            is_zero, torch.log(pr0)[None], torch.log1p(-pr0)[None]
        )

    def log_likelihood(self, outcomes, modelparams, expparams):
        if self.n_outcomes(expparams) == 2:
            return self.log_pr0_to_log_likelihood(
                outcomes, self.pr0(modelparams, expparams)
            )
        raise NotImplementedError(
            "Models with >2 outcomes must override log_likelihood."
        )

    # -- fused single-pass update ------------------------------------------

    def _fused_pr1_parts(self, modelparams, expparams):
        """Optional fused-kernel spec: (pr1_fn, scalars_tail, param_cols)
        with ``pr1_fn(scalars, offset, *cols) -> Pr(1)``."""
        return None

    @property
    def fused_update_supported(self):
        cls = type(self)
        if cls._fused_pr1_parts is FiniteOutcomeModel._fused_pr1_parts:
            return False
        # A subclass that overrides the likelihood (via pr0 or
        # log_likelihood) but inherits _fused_pr1_parts would silently run
        # the ancestor's fused tile: accept an inherited fused spec only
        # when the likelihood comes from no deeper than the spec's class.
        mro = cls.__mro__

        def _definer_idx(name):
            for i, c in enumerate(mro):
                if name in vars(c):
                    return i
            return len(mro)

        fused_idx = _definer_idx("_fused_pr1_parts")
        return fused_idx <= min(
            _definer_idx("pr0"), _definer_idx("log_likelihood")
        )

    def fused_update(self, outcome, log_w, modelparams, expparams,
                     return_stats=False):
        """(log_w', log_norm, ess) in one fused pass (E must be 1); see
        ``ops.fused_update.fused_bayes_update``."""
        from ..ops.fused_update import fused_bayes_update, two_outcome_tile

        if _n_exps(expparams) != 1:
            raise ValueError(
                "fused_update handles exactly one experiment (E == 1); got "
                f"E == {_n_exps(expparams)}. Batch experiments through "
                "batch_update instead."
            )
        parts = self._fused_pr1_parts(modelparams, expparams)
        if parts is None:
            raise NotImplementedError("model does not define _fused_pr1_parts")
        pr1_fn, tail, cols = parts
        outcome = torch.as_tensor(outcome, device=log_w.device)
        scalars = torch.cat(
            [outcome.to(torch.float32).reshape(1), tail.to(torch.float32)]
        )
        return fused_bayes_update(
            two_outcome_tile(pr1_fn), scalars, log_w, cols,
            return_stats=return_stats,
        )

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        return 2
