"""Model DSL on torch tensors.

Counterpart of ``qinfer_tpu/models/base.py``: ``expparams_field``,
``_n_exps``, ``Simulatable`` (with the combinator surface ``base_model``,
``model_chain``, ``underlying_model``, ``all_outcomes``, ``domain``,
``outcome_ndim`` and ``Q``),
``Model``, ``FiniteOutcomeModel`` with the fused single-pass update and
the simulator (``simulate_experiment``, and ``simulate_trials`` for an
ensemble of trials, each at its own parameters and experiment), and
``DifferentiableModel`` (score and Fisher information by autograd). A
model is a frozen dataclass of static metadata with pure methods;
``log_likelihood`` is the primitive, of shape (O, N, E). expparams are a
tensor (single-field models) or a dict of named tensors with leading axis
E. ``all_outcomes`` lies on the device of the expparams' tensors; ``Q`` is
built on the CPU, and its callers move it to the bank's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Union

import torch

from ..domains import Domain, IntegerDomain

__all__ = [
    "Simulatable", "Model", "FiniteOutcomeModel", "DifferentiableModel",
    "expparams_field", "ExpParams",
]

ExpParams = Union[torch.Tensor, Dict[str, torch.Tensor]]


def expparams_field(expparams: ExpParams, name: str):
    """Fetch a named field from expparams; plain tensors are the sole field."""
    if isinstance(expparams, dict):
        return expparams[name]
    return expparams


def _column(expparams: ExpParams, name: str, device):
    """One expparams field as an f32 (E·…,) column on ``device``."""
    v = expparams_field(expparams, name)
    return torch.as_tensor(v, device=device).to(torch.float32).reshape(-1)


def _expparams_device(expparams: ExpParams):
    """The device of the expparams' tensors (the CPU for NumPy arrays and
    numbers)."""
    leaves = expparams.values() if isinstance(expparams, dict) else (
        expparams,)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _expparams_row(expparams: ExpParams, i: int):
    """Experiment i of ``expparams`` with leading axis 1."""
    if isinstance(expparams, dict):
        return {k: v[i:i + 1] for k, v in expparams.items()}
    return expparams[i:i + 1]


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

    @property
    def is_n_outcomes_constant(self) -> bool:
        return True

    @property
    def outcome_ndim(self) -> int:
        """Trailing dimensions of one outcome: 0 for scalar outcomes, 1 for
        vectors (``MultinomialModel``'s counts). The SMC step keeps that
        many trailing axes of an outcome."""
        return 0

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        raise NotImplementedError

    def all_outcomes(self, expparams: ExpParams = None):
        """The outcomes 0 … n_outcomes − 1 as an int32 tensor on the
        device of ``expparams`` (the CPU when there are none)."""
        return torch.arange(self.n_outcomes(expparams), dtype=torch.int32,
                            device=_expparams_device(expparams))

    def domain(self, expparams: ExpParams = None) -> Domain:
        return IntegerDomain(min=0, max=self.n_outcomes(expparams) - 1)

    @property
    def Q(self):
        """Quadratic-loss weights (all ones), on the CPU: callers move
        them to the bank's device."""
        return torch.ones(self.n_modelparams, dtype=torch.float32)

    @property
    def model_chain(self):
        """Chain of underlying models (combinators override)."""
        return ()

    @property
    def base_model(self):
        return self

    @property
    def underlying_model(self):
        return None

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

    def clear_cache(self):
        """No-op: the port keeps no cache of a model's results."""

    def experiment_cost(self, expparams):
        """Cost of each experiment, (E,): 1 each by default."""
        return torch.ones(_n_exps(expparams), dtype=torch.float32,
                          device=_expparams_device(expparams))

    # -- simulation-call bookkeeping (host-side count of simulated
    # experiments: repeat · N · E per simulate_experiment call) ------------

    @property
    def sim_count(self) -> int:
        return self.__dict__.get("_sim_count", 0)

    def reset_sim_count(self):
        object.__setattr__(self, "_sim_count", 0)

    def _bump_sim_count(self, modelparams, expparams, repeat=1):
        n = int(repeat) * int(modelparams.shape[0]) * _n_exps(expparams)
        object.__setattr__(self, "_sim_count", self.sim_count + n)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat: int = 1):
        """Outcomes (repeat, N, E) drawn from ``generator``."""
        raise NotImplementedError

    def simulate_trials(self, generator, modelparams, expparams):
        """One outcome per trial, (T,) int32: trial i's outcome at its own
        parameters ``modelparams[i]`` and its own experiment (row i of
        ``expparams``, E = T). The default runs ``simulate_experiment`` on
        each trial (never the (T, T) table of every pairing)."""
        return torch.stack([
            self.simulate_experiment(generator, modelparams[i:i + 1],
                                     _expparams_row(expparams, i))[0, 0, 0]
            for i in range(modelparams.shape[0])
        ]).to(torch.int32)


@dataclass(frozen=True, eq=False)
class Model(Simulatable):
    """Adds an explicit likelihood."""

    def log_likelihood(self, outcomes, modelparams, expparams):
        """log Pr(outcome | modelparams; expparams), shape (O, N, E)."""
        return torch.log(torch.clamp(
            self.likelihood(outcomes, modelparams, expparams), min=1e-38))

    def likelihood(self, outcomes, modelparams, expparams):
        return torch.exp(self.log_likelihood(outcomes, modelparams, expparams))

    @property
    def is_model_differentiable(self) -> bool:
        # autograd differentiates every torch-implemented model.
        return True


@dataclass(frozen=True, eq=False)
class FiniteOutcomeModel(Model):
    """Models with finitely many outcomes; two-outcome models implement
    ``pr0`` of shape (N, E) and get the likelihood and the fused update."""

    def pr0(self, modelparams, expparams):
        raise NotImplementedError

    @staticmethod
    def pr0_to_likelihood_array(outcomes, pr0):
        """L[o, n, e] = pr0 for outcome 0, else 1 − pr0; (O, N, E)."""
        pr0 = torch.as_tensor(pr0)
        outcomes = torch.as_tensor(outcomes, device=pr0.device).reshape(-1)
        is_zero = (outcomes == 0)[:, None, None]
        return torch.where(is_zero, pr0[None], 1.0 - pr0[None])

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

    def fused_spec(self, outcome, modelparams, expparams):
        """(tile, scalars, param_cols) of the fused update of one
        experiment, with ``scalars`` in the JAX package's layout on the
        bank's device (no host sync)."""
        from ..ops.fused_update import two_outcome_tile

        pr1_fn, tail, cols = self._pr1_parts_or_raise(modelparams, expparams)
        outcome = torch.as_tensor(outcome, device=modelparams.device)
        scalars = torch.cat(
            [outcome.to(torch.float32).reshape(1), tail.to(torch.float32)]
        )
        return two_outcome_tile(pr1_fn), scalars, cols

    def fused_spec_batched(self, outcomes, modelparams, expparams):
        """(tile, scalars (T, k), param_cols (T, N)) of the fused update of
        T banks ``modelparams`` (T, N, D), trial i seeing outcome
        ``outcomes[i]`` of experiment i of ``expparams`` (E = T). Built on
        the device, with no host sync."""
        from ..ops.fused_update import two_outcome_tile

        pr1_fn, tail, cols = self._batched_pr1_parts(modelparams, expparams)
        n_trials = modelparams.shape[0]
        outcomes = torch.as_tensor(outcomes, device=modelparams.device)
        scalars = torch.cat([outcomes.to(torch.float32).reshape(n_trials, 1),
                             tail.to(torch.float32).reshape(n_trials, -1)],
                            dim=1)
        return two_outcome_tile(pr1_fn), scalars, cols

    def _batched_pr1_parts(self, modelparams, expparams):
        if _n_exps(expparams) != modelparams.shape[0]:
            raise ValueError(
                "a batched fused update takes one experiment per trial; got "
                f"E == {_n_exps(expparams)} for {modelparams.shape[0]} trials")
        parts = self._fused_pr1_parts(modelparams, expparams)
        if parts is None:
            raise NotImplementedError("model does not define _fused_pr1_parts")
        return parts

    def _trial_pr1(self, modelparams, expparams):
        """Pr(1) of each trial at its own parameters (T, D) and experiment
        (E = T), (T,), from the model's pr1 tile."""
        pr1_fn, tail, cols = self._batched_pr1_parts(modelparams[:, None, :],
                                                     expparams)
        n_trials = modelparams.shape[0]
        scal = tail.to(torch.float32).reshape(n_trials, -1).T[:, :, None]
        return torch.clamp(pr1_fn(scal, 0, *cols)[:, 0], 0.0, 1.0)

    def _pr1_parts_or_raise(self, modelparams, expparams):
        if _n_exps(expparams) != 1:
            raise ValueError(
                "fused_update handles exactly one experiment (E == 1); got "
                f"E == {_n_exps(expparams)}. Batch experiments through "
                "batch_update instead."
            )
        parts = self._fused_pr1_parts(modelparams, expparams)
        if parts is None:
            raise NotImplementedError("model does not define _fused_pr1_parts")
        return parts

    def fused_update(self, outcome, log_w, modelparams, expparams,
                     return_stats=False):
        """(log_w', log_norm, ess) in one fused pass (E must be 1); see
        ``ops.fused_update.fused_bayes_update``."""
        from ..ops.fused_update import fused_bayes_update

        tile, scalars, cols = self.fused_spec(outcome, modelparams, expparams)
        return fused_bayes_update(tile, scalars, log_w, cols,
                                  return_stats=return_stats)

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        return 2

    # -- simulator -----------------------------------------------------------

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat: int = 1):
        """Categorical draws from the model's own likelihood, (repeat, N,
        E) int32, by inverse CDF over the outcomes with uniforms from
        ``generator``."""
        self._bump_sim_count(modelparams, expparams, repeat)
        outcomes = self.all_outcomes(expparams).to(modelparams.device)
        probs = torch.softmax(
            self.log_likelihood(outcomes, modelparams, expparams), dim=0)
        cdf = torch.cumsum(probs, dim=0)  # (O, N, E)
        u = torch.rand((repeat,) + tuple(cdf.shape[1:]), generator=generator,
                       device=modelparams.device)
        idx = torch.sum(u[None] >= cdf[:-1, None], dim=0)
        return outcomes[idx].to(torch.int32)

    def simulate_trials(self, generator, modelparams, expparams):
        """Two-outcome models with a pr1 tile draw every trial at once:
        outcome 1 with the tile's Pr(1) at the trial's own parameters and
        experiment."""
        if not self.fused_update_supported:
            return super().simulate_trials(generator, modelparams, expparams)
        self._bump_sim_count(modelparams, _expparams_row(expparams, 0))
        pr1 = self._trial_pr1(modelparams, expparams)
        u = torch.rand(pr1.shape, generator=generator, device=pr1.device)
        return (u < pr1).to(torch.int32)


@dataclass(frozen=True, eq=False)
class DifferentiableModel(Model):
    """Adds the score and the Fisher information, by autograd of
    ``log_likelihood``. Both work as unbound calls on any model
    (``DifferentiableModel.score(model, …)``), which is how
    ``SMCUpdaterBCRB`` uses them."""

    def score(self, outcomes, modelparams, expparams):
        """∂ log L / ∂θ, (D, O, N, E), in forward mode as the JAX package's
        ``jax.jacfwd`` takes it: one pass of dual tensors per parameter d,
        every particle's row carrying the tangent e_d (its log-likelihood
        depends on its own row only). Forward mode matters: the
        two-outcome likelihood selects log(pr0) or log1p(−pr0) with
        ``where``, and reverse mode would carry 0·∞ = NaN from the branch
        not taken where pr0 rounds to 0 or 1. (``torch.func``'s ``vmap``
        over ``jacfwd`` computes the same, at ~40 ms of host a call.)"""
        import torch.autograd.forward_ad as fwAD

        mp = modelparams.detach()
        grads = []
        with fwAD.dual_level():
            for d in range(mp.shape[1]):
                tangent = torch.zeros_like(mp)
                tangent[:, d] = 1.0
                out = self.log_likelihood(outcomes, fwAD.make_dual(mp, tangent),
                                          expparams)
                primal, grad = fwAD.unpack_dual(out)
                grads.append(torch.zeros_like(primal) if grad is None
                             else grad)
        return torch.stack(grads)

    def fisher_information(self, modelparams, expparams):
        """F[i, j, n, e] = Σ_o L · score_i · score_j."""
        outcomes = self.all_outcomes(expparams)
        L = self.likelihood(outcomes, modelparams, expparams)  # (O, N, E)
        sc = DifferentiableModel.score(self, outcomes, modelparams, expparams)
        return torch.einsum("one,ione,jone->ijne", L, sc, sc)
