"""Experiment-design heuristics on torch tensors.

Counterpart of ``qinfer_tpu/heuristics.py``: ``keyed_tiebreak_argmax``,
``Heuristic``, ``ExpSparseHeuristic``, ``PGH`` (the particle-guess
heuristic), ``EIGHeuristic`` and ``RiskHeuristic``. Each heuristic has a
pure core ``propose(generator, state, step_idx) -> expparams`` that works on
one bank (locations (N, D): fields of leading axis 1) and on a
trial-batched bank (locations (T, N, D): fields of leading axis T, one
experiment per trial), and the stateful ``__call__`` that draws from the
updater's generator, as the JAX package splits the updater's key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .utils import cumsum_rows

__all__ = ["Heuristic", "ExpSparseHeuristic", "PGH", "EIGHeuristic",
           "RiskHeuristic", "keyed_tiebreak_argmax"]


def _identity(x):
    return x


def keyed_tiebreak_argmax(generator, score):
    """argmax of ``score`` over its last axis with EXACT ties broken
    uniformly at random from ``generator``, never by candidate order.
    Non-tied scores are untouched: the jitter only ranks within the
    argmax tie set."""
    tied = score >= torch.amax(score, dim=-1, keepdim=True)
    jitter = torch.rand(score.shape, generator=generator, device=score.device)
    return torch.argmax(torch.where(tied, jitter, -1.0), dim=-1)


def _banks(state):
    """(locations (T, N, D), log-weights (T, N), batched?) of a state with
    or without a trial axis."""
    locs = state.particle_locations
    if locs.ndim == 3:
        return locs, state.particle_log_weights, True
    return locs[None], state.particle_log_weights[None], False


def _constant_fields(other_fields, n, device):
    return {name: torch.full((n,), float(val), dtype=torch.float32,
                             device=device)
            for name, val in (other_fields or ())}


class Heuristic:
    """ABC holding an updater."""

    def __init__(self, updater):
        self._updater = updater
        self._step = 0

    def propose(self, generator, state, step_idx):
        raise NotImplementedError

    def __call__(self):
        state = self._updater.state
        ep = self.propose(state.generator, state, self._step)
        self._step += 1
        return ep


@dataclass(frozen=True, eq=False)
class _ExpSparseCore:
    """t_k = scale · base^k in f32."""

    scale: float = 1.0
    base: float = 9.0 / 8.0
    t_field: str = "t"
    other_fields: Optional[Tuple[Tuple[str, float], ...]] = None

    def propose(self, generator, state, step_idx):
        del generator
        locs, _, _ = _banks(state)
        n, device = locs.shape[0], locs.device
        f32 = dict(dtype=torch.float32, device=device)
        t = (torch.full((), self.base, **f32)
             ** torch.as_tensor(step_idx, **f32)) * self.scale
        ep = {self.t_field: t.expand(n).clone()}
        ep.update(_constant_fields(self.other_fields, n, device))
        return ep


def _categorical_draws(generator, log_w, n_draws):
    """(T, n_draws) particle indices of each bank, drawn with replacement
    by weight, by inverse CDF over the weights quantized to 2⁻³⁰ (the
    resampler's integer CDF): one exact scan and a binary search per draw.
    (``torch.multinomial`` renormalizes each row in one block, about 0.45
    ms for a row of 2^20 on an H100.) A bank of zero total weight cannot
    reach here (the reset policy restores uniform weights); the check runs
    on the device."""
    q = torch.round(torch.exp(log_w) * float(1 << 30)).to(torch.int64)
    cdf = cumsum_rows(q)
    total = cdf[:, -1:]
    torch._assert_async(torch.all(total > 0))
    u = torch.rand((log_w.shape[0], n_draws), generator=generator,
                   device=log_w.device, dtype=torch.float64)
    u = torch.minimum((u * total).to(torch.int64), total - 1)
    return torch.searchsorted(cdf, u, right=True)


@dataclass(frozen=True, eq=False)
class _PGHCore:
    """Particle-guess heuristic: two particles x₁, x₂ drawn from the
    posterior, t = t_func(1/‖x₁ − x₂‖), the inversion field (if any)
    inv_func(x₁).

    The JAX core redraws both particles while they collide, at most
    ``maxiters`` times, and then floors the distance at ``eps_dist``. Here
    the 1 + ``maxiters`` pairs are drawn at once and the first pair that
    does not collide is taken on the device (the last pair when all
    collide, which hits the floor): the same bounded loop, without a host
    read. ``draw_indices(generator, log_w (T, N), n_draws) -> (T,
    n_draws)`` replaces the categorical draw (pair k is draws 2k, 2k + 1),
    so that tests can inject the indices.
    """

    inv_field: Optional[str] = None
    t_field: str = "t"
    inv_func: Callable = _identity
    t_func: Callable = _identity
    other_fields: Optional[Tuple[Tuple[str, float], ...]] = None
    eps_dist: float = 1e-12
    maxiters: int = 10
    draw_indices: Optional[Callable] = None

    def propose(self, generator, state, step_idx):
        del step_idx
        locs, log_w, batched = _banks(state)
        n_trials, _, d = locs.shape
        n_pairs = self.maxiters + 1
        draw = self.draw_indices or _categorical_draws
        idx = draw(generator, log_w, 2 * n_pairs).to(
            device=locs.device, dtype=torch.int64)
        pairs = torch.gather(locs, 1, idx[:, :, None].expand(-1, -1, d))
        pairs = pairs.reshape(n_trials, n_pairs, 2, d)
        dist = torch.linalg.vector_norm(pairs[:, :, 0] - pairs[:, :, 1],
                                        dim=-1)  # (T, pairs)
        free = dist != 0.0
        first = torch.where(free.any(dim=1),
                            torch.argmax(free.to(torch.int32), dim=1),
                            n_pairs - 1)
        rows = torch.arange(n_trials, device=locs.device)
        t = self.t_func(1.0 / torch.clamp(dist[rows, first],
                                          min=self.eps_dist))
        ep = {self.t_field: t.to(torch.float32)}
        if self.inv_field is not None:
            x1 = pairs[rows, first, 0]  # (T, D)
            ep[self.inv_field] = self.inv_func(x1)
        ep.update(_constant_fields(self.other_fields, n_trials, locs.device))
        if not batched:
            ep = {k: v.reshape((1,) + v.shape[1:]) for k, v in ep.items()}
        return ep


class ExpSparseHeuristic(Heuristic):
    """Exponentially sparse times: t_k = scale · base^k."""

    def __init__(self, updater=None, scale=1.0, base=9.0 / 8.0, t_field="t",
                 other_fields=None):
        super().__init__(updater)
        self.core = _ExpSparseCore(
            scale=float(scale), base=float(base), t_field=t_field,
            other_fields=_freeze_fields(other_fields),
        )

    def propose(self, generator, state, step_idx):
        return self.core.propose(generator, state, step_idx)


class PGH(Heuristic):
    """Particle-guess heuristic; ``draw_indices`` injects the particle
    indices (see ``_PGHCore``)."""

    def __init__(self, updater=None, inv_field=None, t_field="t",
                 inv_func=_identity, t_func=_identity, maxiters=10,
                 other_fields=None, draw_indices=None):
        super().__init__(updater)
        self.core = _PGHCore(
            inv_field=inv_field, t_field=t_field, inv_func=inv_func,
            t_func=t_func, other_fields=_freeze_fields(other_fields),
            maxiters=int(maxiters), draw_indices=draw_indices,
        )

    def propose(self, generator, state, step_idx):
        return self.core.propose(generator, state, step_idx)


@dataclass(frozen=True, eq=False)
class _UtilityGreedyCore:
    """Greedy pick of the candidate with the largest EIG (or the smallest
    Bayes risk), ties broken by ``keyed_tiebreak_argmax``. A batched bank
    scores each trial on its own posterior."""

    model: object = None
    candidates: dict = None  # field -> (C, …) f32 numpy array
    use_eig: bool = True

    def _score(self, state, cand):
        from .smc import bayes_risk_fn, expected_information_gain_fn

        if self.use_eig:
            return expected_information_gain_fn(self.model, state, cand)
        return -bayes_risk_fn(self.model, state, cand, self.model.Q)

    def propose(self, generator, state, step_idx):
        del step_idx
        locs, log_w, batched = _banks(state)
        cand = {k: torch.as_tensor(v, device=locs.device)
                for k, v in self.candidates.items()}
        score = torch.stack([
            self._score(dataclasses.replace(
                state, particle_locations=locs[i],
                particle_log_weights=log_w[i]), cand)
            for i in range(locs.shape[0])
        ])  # (T, C)
        best = keyed_tiebreak_argmax(generator, score)  # (T,)
        ep = {k: v[best] for k, v in cand.items()}
        return ep if batched else {k: v[:1] for k, v in ep.items()}


def _candidates(candidates):
    return {name: np.asarray(arr, np.float32)
            for name, arr in sorted(candidates.items())}


class EIGHeuristic(Heuristic):
    """Pick the candidate experiment with maximal expected information
    gain, on the device."""

    def __init__(self, updater=None, model=None, candidates=None):
        super().__init__(updater)
        if model is None and updater is not None:
            model = updater.model
        self.core = _UtilityGreedyCore(
            model=model, candidates=_candidates(candidates), use_eig=True)

    def propose(self, generator, state, step_idx):
        return self.core.propose(generator, state, step_idx)


class RiskHeuristic(Heuristic):
    """Pick the candidate experiment with minimal Bayes risk, on the
    device."""

    def __init__(self, updater=None, model=None, candidates=None):
        super().__init__(updater)
        if model is None and updater is not None:
            model = updater.model
        self.core = _UtilityGreedyCore(
            model=model, candidates=_candidates(candidates), use_eig=False)

    def propose(self, generator, state, step_idx):
        return self.core.propose(generator, state, step_idx)


def _freeze_fields(other_fields):
    if other_fields is None:
        return None
    if isinstance(other_fields, dict):
        return tuple(sorted(other_fields.items()))
    return tuple(other_fields)
