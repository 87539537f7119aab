"""SMC inference engine on torch tensors.

Counterpart of ``qinfer_tpu/smc.py``: ``SMCState``, ``SMCConfig``,
``init_smc_state``, ``smc_update_step``, ``smc_batch_update``, the design
functions ``hypothetical_log_update``, ``bayes_risk_fn`` and
``expected_information_gain_fn``, the stateful ``SMCUpdater`` (with the
resampling-divergence record, credible regions, marginals, the KDE mesh,
the plots and ``sample``), ``SMCUpdaterBCRB`` and
``MixedApproximateSMCUpdater``. The bank keeps log-space f32 weights on
one device; randomness comes from the ``torch.Generator`` carried in the
state.

Control flow runs on the host. The JAX package's ``lax.cond`` on
ESS < threshold·N becomes an ``if`` on the ESS, which costs one device→host
sync per update; its ``lax.scan`` over the record becomes a Python loop.
On CUDA the Bayes update runs kernel B1 and the resample kernel B2. The
design functions are plain torch products over the bank (the JAX package
leaves them to XLA, outside any kernel).

An ensemble of T independent trials (the JAX package's ``vmap`` over
``smc_update_step``) is an ``SMCState`` with a leading trial axis, built by
``init_batched_smc_state`` and advanced by ``smc_update_step_batched``:
one launch of B1 for all trials, one host read of the resample mask, and a
resample (one launch of B2) of only the trials that need it.

Entry points run on the card unless the caller asks for the CPU:
``SMCUpdater`` and its subclasses default to ``device="cuda"`` and raise
when torch sees no CUDA device.

The posterior summaries sort, cut, bin and sum on the bank's device; the
convex hull, ``Delaunay``, ``mvee`` and ``_gaussian_kl`` run on the host in
f64, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ._exceptions import ApproximationWarning
from .distributions import Distribution, ParticleDistribution
from .models.base import (
    DifferentiableModel,
    FiniteOutcomeModel,
    Simulatable,
    _expparams_row,
    _n_exps,
)
from .models.derived import DerivedModel
from .ops.fused_update import (
    MAX_COLS,
    fused_bayes_update,
    fused_bayes_update_batched,
)
from .profiling import count, span
from .resamplers import LiuWestResampler
from .utils import (
    effective_sample_size,
    in_ellipsoid,
    mvee,
    particle_covariance_mtx,
    particle_mean,
    pytree_to_expparams,
)

__all__ = [
    "SMCState", "SMCConfig", "SMCUpdater", "SMCUpdaterBCRB",
    "MixedApproximateSMCUpdater", "init_smc_state",
    "smc_update_step", "smc_batch_update", "hypothetical_log_update",
    "bayes_risk_fn", "expected_information_gain_fn",
    "init_batched_smc_state", "smc_update_step_batched", "resolve_device",
]

# Particles a chunk of ``posterior_mesh``'s sum: two (chunk, res) f32
# factors, 26 MB each at res = 100.
_MESH_CHUNK = 1 << 16

_LOG_TINY = -87.0  # exp(-87) ~ 1.6e-38, smallest safe f32 log-likelihood


@dataclass(frozen=True)
class SMCState:
    """The complete SMC state. Scalars are 0-d tensors on the bank's device
    so that an update needs no sync to keep them."""

    particle_locations: torch.Tensor  # f32[N, D]
    particle_log_weights: torch.Tensor  # f32[N], normalized: logsumexp == 0
    generator: torch.Generator
    n_resamples: torch.Tensor  # i32
    min_n_ess: torch.Tensor  # f32
    log_total_likelihood: torch.Tensor  # f32 (model evidence)
    just_resampled: torch.Tensor  # bool
    n_zero_weight_events: torch.Tensor  # i32


@dataclass(frozen=True)
class SMCConfig:
    """Constructor kwargs of the reference ``SMCUpdater`` as static config."""

    resample_thresh: float = 0.5
    zero_weight_policy: str = "error"  # 'error' | 'warn' | 'reset' | 'ignore'
    zero_weight_thresh: float = 1e-10
    # Fused update (models exposing ``fused_update``): None = kernel B1
    # whenever the bank is on CUDA; True forces the fused route (its plain
    # version on the CPU); False takes the unfused path.
    use_fused_update: Optional[bool] = None


def resolve_device(device):
    """``device`` as a ``torch.device``; a CUDA device that torch cannot
    see raises (an entry point never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qinfer_tpu_torch runs on a CUDA device by default and torch "
            "sees none; pass device='cpu' to run on the CPU")
    return device


def _uniform_log_weights(n, device, n_trials=None):
    shape = (n,) if n_trials is None else (n_trials, n)
    return torch.full(shape, -math.log(n), dtype=torch.float32, device=device)


def init_smc_state(generator, model, n_particles: int,
                   prior: Distribution) -> SMCState:
    """Draw the initial cloud from the prior (on ``generator``'s device)
    with uniform weights."""
    del model
    locs = prior.sample(generator, n_particles).to(torch.float32)
    device = locs.device

    def scalar(value, dtype):
        return torch.full((), value, dtype=dtype, device=device)

    return SMCState(
        particle_locations=locs,
        particle_log_weights=_uniform_log_weights(n_particles, device),
        generator=generator,
        n_resamples=scalar(0, torch.int32),
        min_n_ess=scalar(float(n_particles), torch.float32),
        log_total_likelihood=scalar(0.0, torch.float32),
        just_resampled=scalar(False, torch.bool),
        n_zero_weight_events=scalar(0, torch.int32),
    )


def init_batched_smc_state(generator, model, n_trials: int, n_particles: int,
                           prior: Distribution) -> SMCState:
    """T independent initial clouds: an ``SMCState`` whose tensors carry a
    leading trial axis (locations (T, N, D), log-weights (T, N), counters
    (T,)), drawn in one call from ``generator``."""
    del model
    locs = prior.sample(generator, n_trials * n_particles).to(torch.float32)
    locs = locs.reshape(n_trials, n_particles, -1)
    device = locs.device

    def per_trial(value, dtype):
        return torch.full((n_trials,), value, dtype=dtype, device=device)

    return SMCState(
        particle_locations=locs,
        particle_log_weights=_uniform_log_weights(n_particles, device,
                                                  n_trials),
        generator=generator,
        n_resamples=per_trial(0, torch.int32),
        min_n_ess=per_trial(float(n_particles), torch.float32),
        log_total_likelihood=per_trial(0.0, torch.float32),
        just_resampled=per_trial(False, torch.bool),
        n_zero_weight_events=per_trial(0, torch.int32),
    )


def resample_state(model, resampler, state: SMCState) -> SMCState:
    """The state after one resample: new locations, uniform weights."""
    with span("qinfer.resamplers.resample"):
        new_locs = resampler(state.generator, model,
                             state.particle_locations,
                             state.particle_log_weights)
        n = new_locs.shape[0]
        return dataclasses.replace(
            state,
            particle_locations=new_locs,
            particle_log_weights=_uniform_log_weights(n, new_locs.device),
            n_resamples=state.n_resamples + 1,
            just_resampled=torch.ones((), dtype=torch.bool,
                                      device=new_locs.device),
        )


def _psum(x, group, op=None):
    """``x`` summed over the ranks of ``group`` (another ``ReduceOp`` with
    ``op``), as a new tensor; ``x`` itself when ``group`` is None (one
    bank). The counterpart of the JAX package's ``_psum``/``axis_name``."""
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def _pmax(x, group):
    return _psum(x, group, dist.ReduceOp.MAX)


def hypothetical_log_update(model, state: SMCState, outcomes, expparams,
                            group=None):
    """Log-space hypothetical update: (log_w_hyp[O, E, N], log_norm[O, E]),
    where log_norm[o, e] = log Pr(outcome o | expparam e) under the current
    posterior and log_w_hyp is normalized over N.

    ``group``: the bank is one rank's block of a bank spread over the
    ranks of this process group (``qinfer_tpu_torch.parallel``); the
    normalization is then a max and a sum across the ranks."""
    log_L = model.log_likelihood(outcomes, state.particle_locations,
                                 expparams)  # (O, N, E)
    # Lower clip only: log-densities may exceed 0.
    log_L = torch.clamp(log_L, min=_LOG_TINY)
    log_w_hyp = state.particle_log_weights[None, :, None] + log_L
    if group is None:
        log_norm = torch.logsumexp(log_w_hyp, dim=1)  # (O, E)
    else:
        m = _pmax(torch.amax(log_w_hyp, dim=1), group)
        log_norm = m + torch.log(_psum(
            torch.sum(torch.exp(log_w_hyp - m[:, None, :]), dim=1), group))
    log_w_hyp = log_w_hyp - log_norm[:, None, :]
    return log_w_hyp.transpose(1, 2), log_norm


def _outcome_rows(model, outcomes):
    """Outcomes as the O axis the likelihood takes: (O,) scalars, or (O, k)
    when the model's outcomes are vectors (``outcome_ndim`` ≥ 1: the
    trailing axis is one outcome)."""
    if getattr(model, "outcome_ndim", 0) >= 1:
        return outcomes.reshape(-1, outcomes.shape[-1])
    return outcomes.reshape(-1)


def smc_update_step(model, resampler, config: SMCConfig, state: SMCState,
                    outcome, expparams):
    """One Bayes update + conditional resample.

    Returns (new_state, log_norm) with log_norm the single-update evidence
    log Pr(outcome | expparam) as a 0-d tensor.
    """
    with span("qinfer.smc.step"):
        with span("qinfer.smc.update"):
            log_w, log_norm, ess, is_zero = _bayes_update(
                model, config, state, outcome, expparams)
            state = _recorded(state, log_norm, ess, is_zero,
                              particle_log_weights=log_w)
        device = log_w.device
        n = log_w.shape[0]
        count("smc.steps")

        # The one host sync of the step (lax.cond in the JAX package).
        with span("qinfer.sync.ess"):
            resample = bool(ess < config.resample_thresh * n)
        if resample:
            state = resample_state(model, resampler, state)
        else:
            state = dataclasses.replace(
                state, just_resampled=torch.zeros((), dtype=torch.bool,
                                                  device=device))

        # Time-dependent models diffuse the cloud after the update; skipped
        # for static models.
        if _is_time_dependent(model):
            new_locs = model.update_timestep(
                state.particle_locations, expparams, generator=state.generator
            )[:, :, 0]
            state = dataclasses.replace(state, particle_locations=new_locs)

        return state, log_norm


def _b1_spec(model, config, locs, outcomes, expparams):
    """B1's ``(tile, scalars, cols)`` for the Bayes update of the bank
    ``locs``, (N, D) or T banks (T, N, D) (trial i seeing ``outcomes[i]`` of
    experiment i), or None where the update takes the unfused route. B1 (its
    plain version on the CPU) runs where the model has a B1 tile and
    ``use_fused_update`` is True, or None with the bank on CUDA. On CUDA a
    tile with a functor over more than ``MAX_COLS`` columns (the Born rule
    above three qubits), which the kernel refuses, takes the unfused route,
    decided from the column count before B1 launches and counted on the
    wrapper as ``unfused_wide``. The one-bank, batched and sharded steps
    share this choice."""
    if not getattr(model, "fused_update_supported", False):
        return None
    use = config.use_fused_update
    if not (locs.is_cuda if use is None else use):
        return None
    if locs.ndim == 3:
        spec = model.fused_spec_batched(outcomes, locs, expparams)
    else:
        spec = model.fused_spec(outcomes[0], locs, expparams)
    tile, _, cols = spec
    if (locs.is_cuda and len(cols) > MAX_COLS
            and getattr(tile, "kernel_tile", None) is not None):
        wrapper = (fused_bayes_update_batched if locs.ndim == 3
                   else fused_bayes_update)
        wrapper.unfused_wide += 1
        count(f"ops.{wrapper.__name__}.unfused_wide")
        return None
    return spec


def _per_bank(x):
    """A value of each bank, () or (T,), shaped to broadcast over its
    bank's weights, (N,) or (T, N)."""
    return x if x.ndim == 0 else x[:, None]


def _bayes_update(model, config, state, outcomes, expparams):
    """The Bayes update of one bank, log-weights (N,), or of T banks, (T,
    N), over the last axis, through the zero-weight reset: (the normalized
    log-weights, log_norm, ess, is_zero), each of the last three () or
    (T,). B1 runs on ``_b1_spec``'s tile where it gives one, else the
    likelihood; the shape picks the call alone: of one bank
    ``fused_bayes_update`` or ``model.log_likelihood`` of the one outcome;
    of T banks B1's batched launch or the likelihood trial by trial, trial
    i seeing ``outcomes[i]`` of experiment i."""
    log_w = state.particle_log_weights
    locs = state.particle_locations
    batched = log_w.ndim == 2
    outcomes = _outcome_rows(model, torch.as_tensor(outcomes,
                                                    device=log_w.device))
    spec = _b1_spec(model, config, locs, outcomes, expparams)
    if spec is not None:
        update = fused_bayes_update_batched if batched else fused_bayes_update
        log_w_norm, log_norm, ess = update(spec[0], spec[1], log_w, spec[2])
    else:
        if batched:
            log_L = _batched_log_likelihood(model, outcomes, locs, expparams)
        else:
            log_L = model.log_likelihood(outcomes[:1], locs,
                                         expparams)[0, :, 0]
        log_w_new = log_w + torch.clamp(log_L, min=_LOG_TINY)  # lower only
        # One shared max feeds both reductions: ESS = s1²/s2.
        m = torch.amax(log_w_new, dim=-1)
        shifted = torch.exp(log_w_new - _per_bank(m))
        s1 = torch.sum(shifted, dim=-1)
        s2 = torch.sum(shifted * shifted, dim=-1)
        log_norm = m + torch.log(s1)
        log_w_norm = log_w_new - _per_bank(log_norm)
        ess = s1 * s1 / s2
    log_w_norm, ess, is_zero = _zero_weight_reset(
        config, log_w_norm, log_norm, ess, log_w.shape[-1])
    return log_w_norm, log_norm, ess, is_zero


def _zero_weight_reset(config, log_w_norm, log_norm, ess, n):
    """The zero-weight test of each bank (its evidence below
    ``zero_weight_thresh``) and, under the 'reset' policy, such a bank's
    weights made uniform over ``n`` particles and its ESS set to n:
    (log_w_norm, ess, is_zero). An ``ess`` of None stays None (the sharded
    unfused update takes it from the reset weights)."""
    is_zero = log_norm < math.log(config.zero_weight_thresh)
    if config.zero_weight_policy == "reset":
        device = log_w_norm.device
        uniform = torch.full(log_w_norm.shape[-1:], -math.log(n),
                             dtype=torch.float32, device=device)
        log_w_norm = torch.where(_per_bank(is_zero), uniform, log_w_norm)
        if ess is not None:
            ess = torch.where(is_zero, torch.full((), float(n), device=device),
                              ess)
    return log_w_norm, ess, is_zero


def _recorded(state, log_norm, ess, is_zero, **fields):
    """``state`` with ``fields`` replaced and the update's record kept: the
    evidence summed, the least ESS and the zero-weight events counted."""
    return dataclasses.replace(
        state,
        log_total_likelihood=state.log_total_likelihood + log_norm,
        min_n_ess=torch.minimum(state.min_n_ess, ess),
        n_zero_weight_events=state.n_zero_weight_events + is_zero.to(
            torch.int32),
        **fields,
    )


def _batched_log_likelihood(model, outcomes, locs, expparams):
    """(T, N) log-likelihood of trial i's outcome at its own experiment,
    one trial at a time (never the (T, T) table of every pairing)."""
    return torch.stack([
        model.log_likelihood(outcomes[i:i + 1], locs[i],
                             _expparams_row(expparams, i))[0, :, 0]
        for i in range(locs.shape[0])
    ])


def smc_update_step_batched(model, resampler, config: SMCConfig,
                            state: SMCState, outcomes, expparams, u0=None):
    """One Bayes update + conditional resample of each of T trials.

    ``state`` carries a leading trial axis (``init_batched_smc_state``);
    ``outcomes``: (T,) [or (T, k)]; ``expparams``: one experiment per
    trial (E = T).
    The update of every trial is one launch of kernel B1 on CUDA (its plain
    version on the CPU, or the unfused likelihood trial by trial when the
    model has no fused tile or the config turns it off). The resample mask
    is read once on the host, and only the trials below the threshold are
    resampled, together (``resampler.batched``; ``u0`` (T,) injects their
    stratum offsets). ``zero_weight_policy="reset"`` acts per trial.
    Returns (new_state, log_norm (T,)).
    """
    with span("qinfer.smc.step"):
        with span("qinfer.smc.update"):
            log_w, log_norm, ess, is_zero = _bayes_update(
                model, config, state, outcomes, expparams)
            n_trials, n = log_w.shape
            need = ess < config.resample_thresh * n
            state = _recorded(state, log_norm, ess, is_zero,
                              particle_log_weights=log_w,
                              n_resamples=state.n_resamples + need.to(
                                  torch.int32),
                              just_resampled=need)
        device = log_w.device
        count("smc.steps")

        # The one host sync of the step: which trials resample.
        with span("qinfer.sync.mask"):
            idx = torch.nonzero(need).squeeze(1)
        if idx.numel() > 0:
            with span("qinfer.resamplers.resample"):
                new_locs = resampler.batched(
                    state.generator, model, state.particle_locations[idx],
                    state.particle_log_weights[idx],
                    u0=None if u0 is None
                    else torch.as_tensor(u0, device=device)[idx])
                locs = state.particle_locations.index_copy(0, idx, new_locs)
                log_w = state.particle_log_weights.index_fill(
                    0, idx, -math.log(n))
                state = dataclasses.replace(state, particle_locations=locs,
                                            particle_log_weights=log_w)

        if _is_time_dependent(model):
            walked = [
                model.update_timestep(state.particle_locations[i],
                                      _expparams_row(expparams, i),
                                      generator=state.generator)[:, :, 0]
                for i in range(n_trials)
            ]
            state = dataclasses.replace(
                state, particle_locations=torch.stack(walked))

        return state, log_norm


def _is_time_dependent(model) -> bool:
    """True iff the model overrides ``Simulatable.update_timestep``,
    directly or through a combinator chain (``DerivedModel`` only
    delegates)."""
    ts = type(model).update_timestep
    if ts is Simulatable.update_timestep:
        return False
    if isinstance(model, DerivedModel) and ts is DerivedModel.update_timestep:
        return _is_time_dependent(model.underlying_model)
    return True


def _expparams_to(expparams, device):
    """expparams on ``device``; a NumPy record array (the reference's
    native format) becomes a dict of its fields."""
    if isinstance(expparams, np.ndarray) and expparams.dtype.names:
        expparams = pytree_to_expparams(expparams)
    if isinstance(expparams, dict):
        return {k: torch.as_tensor(v, device=device)
                for k, v in expparams.items()}
    return torch.as_tensor(expparams, device=device)


def smc_batch_update(model, resampler, config: SMCConfig, state: SMCState,
                     outcomes, expparams):
    """Run the update step over a record of T experiments.

    ``outcomes``: (T,) [or (T, k) for vector outcomes]; ``expparams``:
    tensor or dict of tensors with leading axis T (each step sees a
    single-experiment slice, E=1).
    Returns (state, log_norms[T]).
    """
    device = state.particle_log_weights.device
    outcomes = torch.as_tensor(outcomes, device=device)
    expparams = _expparams_to(expparams, device)
    log_norms = []
    for i in range(outcomes.shape[0]):
        state, log_norm = smc_update_step(
            model, resampler, config, state, outcomes[i],
            _expparams_row(expparams, i),
        )
        log_norms.append(log_norm)
    return state, torch.stack(log_norms)


def _streaming_pr1(model, state: SMCState, expparams, outcomes):
    """Pr(outcome 1 | particle, candidate) as one (N, E) tensor, or None.

    The streaming routes apply to plain two-outcome models whose outcomes
    are [0, 1] and whose likelihood is the pr0-routed default (a model that
    overrides ``log_likelihood``, such as ``BinomialModel``, takes the
    general route). Outcomes held on the host are checked there; outcomes
    on the device are not read back (that would be a sync): they are
    accepted only when the model enumerates its outcomes with the default
    arange, which makes a (2,) vector [0, 1].
    """
    if not isinstance(model, FiniteOutcomeModel):
        return None
    if type(model).pr0 is FiniteOutcomeModel.pr0:
        return None
    if type(model).log_likelihood is not FiniteOutcomeModel.log_likelihood:
        return None
    try:
        if model.n_outcomes(expparams) != 2:
            return None
    except (TypeError, ValueError):
        return None
    if tuple(getattr(outcomes, "shape", ())) != (2,):
        return None
    if isinstance(outcomes, torch.Tensor) and outcomes.device.type != "cpu":
        if type(model).all_outcomes is not Simulatable.all_outcomes:
            return None
    elif np.asarray(outcomes).tolist() != [0, 1]:
        return None
    return torch.clamp(1.0 - model.pr0(state.particle_locations, expparams),
                       0.0, 1.0)  # (N, E)


def bayes_risk_fn(model, state: SMCState, expparams, Q=None, outcomes=None,
                  group=None):
    """Expected posterior quadratic loss per candidate experiment, (E,):
    risk(e) = Σ_o Pr(o|e) · tr[Q · Cov_post(o, e)].

    Two-outcome models stream from one (N, E) pr1 tensor, with the
    per-outcome second moments centered at the current posterior mean;
    other models take the general (O, N, E) route, also centered.
    ``outcomes``: pre-enumerated outcomes (``model.all_outcomes`` when
    None). ``Q`` is moved to the bank's device. ``group``: the bank is one
    rank's block (see ``hypothetical_log_update``); every sum over the
    particles is all-reduced across the ranks.
    """
    if outcomes is None:
        outcomes = model.all_outcomes(expparams)
    locs = state.particle_locations  # (N, D)
    device = locs.device
    q = (torch.ones(locs.shape[1], dtype=torch.float32, device=device)
         if Q is None else torch.as_tensor(Q, dtype=torch.float32,
                                           device=device))
    w = torch.exp(state.particle_log_weights)  # (N,)
    mu_hat = _psum(w @ locs, group)  # (D,) posterior mean, the centering
    y = locs - mu_hat[None, :]

    pr1 = _streaming_pr1(model, state, expparams, outcomes)
    if pr1 is not None:
        # Sufficient statistics over the bank: marg1 = Σ w·pr1 (evidence of
        # outcome 1), A = Σ w·pr1·y, B = Σ w·pr1·y² (outcome-1 moments),
        # T = Σ w·y, U = Σ w·y² (totals: outcome 0 is total − outcome 1).
        wp = w[:, None] * pr1  # (N, E)
        marg1 = _psum(wp.sum(0), group)
        marg0 = torch.clamp(1.0 - marg1, 0.0, 1.0)
        A = _psum(wp.T @ y, group)
        B = _psum(wp.T @ (y * y), group)
        T = _psum(w @ y, group)
        U = _psum(w @ (y * y), group)

        def tr_qvar(m, a, b):
            m_safe = torch.clamp(m, min=1e-30)[:, None]
            var = torch.clamp(b / m_safe - (a / m_safe) ** 2, min=0.0)
            return var @ q  # (E,)

        return (marg1 * tr_qvar(marg1, A, B)
                + marg0 * tr_qvar(marg0, T[None, :] - A, U[None, :] - B))

    log_w_hyp, log_norm = hypothetical_log_update(model, state, outcomes,
                                                  expparams, group)
    w_hyp = torch.exp(log_w_hyp)  # (O, E, N)
    mu = _psum(w_hyp @ y, group)  # (O, E, D)
    second = _psum(w_hyp @ (y * y), group)
    var = torch.clamp(second - mu * mu, min=0.0)
    return torch.sum(torch.exp(log_norm) * (var @ q), dim=0)


def expected_information_gain_fn(model, state: SMCState, expparams,
                                 outcomes=None, group=None):
    """Mutual information I(outcome; params | e) per candidate, (E,):
    IG(e) = H[Σ_n w_n L(o|n,e)] − Σ_n w_n H[L(·|n,e)].

    Two-outcome models stream from one (N, E) pr1 tensor (the binary
    entropy replaces the (O, N, E) log-likelihood); other models take the
    general route, with xlogy's 0·log 0 = 0. ``group``: as in
    ``bayes_risk_fn``.
    """
    with span("qinfer.design.eig"):
        if outcomes is None:
            outcomes = model.all_outcomes(expparams)
        w = torch.exp(state.particle_log_weights)  # (N,)

        pr1 = _streaming_pr1(model, state, expparams, outcomes)
        if pr1 is not None:
            marg1 = _psum(w @ pr1, group)  # (E,)
            marg0 = torch.clamp(1.0 - marg1, 0.0, 1.0)
            h_marg = -(torch.xlogy(marg1, marg1) + torch.xlogy(marg0, marg0))
            pr0 = 1.0 - pr1
            # (N, E)
            h_bin = -(torch.xlogy(pr1, pr1) + torch.xlogy(pr0, pr0))
            return h_marg - _psum(w @ h_bin, group)

        log_L = torch.clamp(
            model.log_likelihood(outcomes, state.particle_locations, expparams),
            _LOG_TINY, 0.0)  # (O, N, E)
        L = torch.exp(log_L)
        marg = _psum(torch.einsum("n,one->oe", w, L), group)  # Pr(o | e)
        h_marg = -torch.sum(torch.xlogy(marg, marg), dim=0)
        h_cond = -_psum(torch.einsum("n,one->e", w, L * log_L), group)
        return h_marg - h_cond


# ---------------------------------------------------------------------------
# Stateful host wrapper — reference API surface
# ---------------------------------------------------------------------------

class SMCUpdater(ParticleDistribution):
    """Sequential-Monte-Carlo Bayesian updater.

    Same constructor as the JAX package's ``SMCUpdater``, plus ``device``
    (``"cuda"`` unless the caller asks for the CPU; raises when torch sees
    no CUDA device) and an optional ``generator`` (which then fixes the
    device) in place of ``key``.

    ``bayes_risk`` and ``expected_information_gain`` take candidate
    expparams (E,) and return (E,) tensors on the bank's device, or a 0-d
    tensor when E == 1. The estimators, ``est_credible_region``,
    ``posterior_marginal``, ``posterior_mesh`` and ``sample`` return
    tensors on the bank's device; ``region_est_hull``,
    ``region_est_ellipsoid`` and ``in_credible_region`` return NumPy, as
    the JAX package does.

    With ``track_resampling_divergence`` (or a resampler with
    ``host_side`` set), ``update`` runs the step without its resample and
    resamples after it when ``n_ess`` < threshold·N, recording the
    moment-matched Gaussian KL of each resample in
    ``resampling_divergences``; ``batch_update`` then replays the record
    update by update.
    """

    def __init__(
        self,
        model,
        n_particles: int,
        prior: Distribution,
        resample_a: Optional[float] = None,
        resampler: Optional[LiuWestResampler] = None,
        resample_thresh: float = 0.5,
        zero_weight_policy: str = "error",
        zero_weight_thresh: float = 1e-10,
        track_resampling_divergence: bool = False,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        self.model = model
        self.prior = prior
        self._n_particles = int(n_particles)
        if resampler is None:
            resampler = LiuWestResampler(
                a=0.98 if resample_a is None else float(resample_a)
            )
        self.resampler = resampler
        if zero_weight_policy not in ("error", "warn", "reset", "ignore"):
            raise ValueError(
                f"Unknown zero_weight_policy {zero_weight_policy!r}; "
                "expected 'error', 'warn', 'reset', or 'ignore'."
            )
        self.config = SMCConfig(
            resample_thresh=float(resample_thresh),
            zero_weight_policy=zero_weight_policy,
            zero_weight_thresh=float(zero_weight_thresh),
        )
        self._no_resample_config = dataclasses.replace(
            self.config, resample_thresh=-1.0)
        self._track_rsd = bool(track_resampling_divergence)

        self.data_record = []
        self.normalization_record = []
        self.resampling_divergences = [] if self._track_rsd else None
        self._call_count = 0

        if generator is None:
            generator = torch.Generator(device=resolve_device(device))
            generator.manual_seed(seed)
        self.device = generator.device
        self._init_generator_state = generator.get_state()
        self.state = init_smc_state(generator, model, self._n_particles,
                                    prior)

    # -- properties (reference parity) ------------------------------------

    @property
    def n_particles(self):
        return self._n_particles

    @property
    def particle_locations(self):
        return self.state.particle_locations

    @property
    def particle_log_weights(self):
        return self.state.particle_log_weights

    @property
    def particle_weights(self):
        return torch.exp(self.state.particle_log_weights)

    @property
    def resample_count(self):
        return int(self.state.n_resamples)

    @property
    def just_resampled(self):
        return bool(self.state.just_resampled)

    @property
    def log_total_likelihood(self):
        return float(self.state.log_total_likelihood)

    @property
    def total_likelihood(self):
        return math.exp(self.log_total_likelihood)

    @property
    def min_n_ess(self):
        return float(self.state.min_n_ess)

    @property
    def data_record_array(self):
        return np.asarray(self.data_record)

    @property
    def n_ess(self):
        """ESS = 1/Σwᵢ²."""
        return effective_sample_size(self.state.particle_log_weights)

    # -- lifecycle ---------------------------------------------------------

    def reset(self, n_particles=None, only_params=None, fresh_rng=True):
        """Re-draw the particles from the prior and clear the records.

        ``fresh_rng=True`` draws from the updater's generator where it now
        stands; ``fresh_rng=False`` first puts the generator back to its
        state at construction, which replays the initial cloud exactly.
        """
        if n_particles is not None:
            self._n_particles = int(n_particles)
        if only_params is not None:
            raise NotImplementedError("only_params reset is not supported.")
        generator = self.state.generator
        if not fresh_rng:
            generator.set_state(self._init_generator_state)
        self.state = init_smc_state(generator, self.model, self._n_particles,
                                    self.prior)
        self.data_record = []
        self.normalization_record = []
        if self._track_rsd:
            self.resampling_divergences = []

    # -- updates -----------------------------------------------------------

    @property
    def _eager_resample(self):
        """Whether resampling runs on the host after the step: for
        divergence tracking and for host-side resamplers."""
        return getattr(self.resampler, "host_side", False) or self._track_rsd

    def hypothetical_update(self, outcomes, expparams,
                            return_likelihood=False,
                            return_normalization=False):
        """Linear weights (O, E, N) [+ normalization (O, E, 1)]
        [+ likelihood (O, N, E)] of the hypothetical updates."""
        expparams = _expparams_to(expparams, self.device)
        outcomes = _outcome_rows(self.model,
                                 torch.as_tensor(outcomes, device=self.device))
        log_w_hyp, log_norm = hypothetical_log_update(
            self.model, self.state, outcomes, expparams)
        self._call_count += (outcomes.shape[0] * self._n_particles
                             * _n_exps(expparams))
        out = [torch.exp(log_w_hyp)]
        if return_normalization:
            out.append(torch.exp(log_norm)[:, :, None])
        if return_likelihood:
            out.append(torch.exp(self.model.log_likelihood(
                outcomes, self.state.particle_locations, expparams)))
        return out[0] if len(out) == 1 else tuple(out)

    def update(self, outcome, expparams, check_for_resample=True):
        """One Bayes update (+ conditional resample).
        ``check_for_resample=False`` skips the resample for this call."""
        eager = self._eager_resample
        config = (self._no_resample_config
                  if eager or not check_for_resample else self.config)
        expparams = _as_single_expparams(expparams, self.device)
        prev_zero = int(self.state.n_zero_weight_events)
        self.state, log_norm = smc_update_step(
            self.model, self.resampler, config, self.state, outcome, expparams
        )
        # The eager test reads n_ess from the new log-weights, as the JAX
        # package does (not the step's own ESS).
        if (eager and check_for_resample and float(self.n_ess)
                < self.config.resample_thresh * self._n_particles):
            self.resample()
        self._call_count += self._n_particles
        self.data_record.append(
            (np.asarray(torch.as_tensor(outcome).cpu()),
             _expparams_numpy(expparams))
        )
        self.normalization_record.append(float(torch.exp(log_norm)))
        self._check_zero_weight(prev_zero)
        return self

    def batch_update(self, outcomes, expparams):
        """Replay a record of T experiments (update by update through
        ``update`` when resampling is eager)."""
        expparams = _expparams_to(expparams, self.device)
        if self._eager_resample:
            outcomes = torch.as_tensor(outcomes).cpu()
            for i in range(int(outcomes.shape[0])):
                self.update(outcomes[i], _expparams_row(expparams, i))
            return self
        outcomes = torch.as_tensor(outcomes, device=self.device)
        prev_zero = int(self.state.n_zero_weight_events)
        self.state, log_norms = smc_batch_update(
            self.model, self.resampler, self.config, self.state,
            outcomes, expparams,
        )
        n_exp = int(outcomes.shape[0])
        self._call_count += self._n_particles * n_exp
        self.normalization_record.extend(torch.exp(log_norms).tolist())
        outcomes_np = outcomes.cpu().numpy()
        ep_np = _expparams_numpy(expparams)
        for i in range(n_exp):
            row = ({k: v[i] for k, v in ep_np.items()}
                   if isinstance(ep_np, dict) else ep_np[i])
            self.data_record.append((outcomes_np[i], row))
        self._check_zero_weight(prev_zero)
        return self

    def resample(self):
        """Force a resample now (recording its divergence when tracked)."""
        if self._track_rsd:
            pre_w = np.exp(_host_f64(self.state.particle_log_weights))
            pre_locs = _host_f64(self.state.particle_locations)
        self.state = resample_state(self.model, self.resampler, self.state)
        if self._track_rsd:
            post_locs = _host_f64(self.state.particle_locations)
            post_w = np.full(post_locs.shape[0], 1.0 / post_locs.shape[0])
            self.resampling_divergences.append(
                _gaussian_kl(pre_w, pre_locs, post_w, post_locs))
        return self

    def _check_zero_weight(self, prev_count):
        events = int(self.state.n_zero_weight_events) - prev_count
        if events <= 0:
            return
        policy = self.config.zero_weight_policy
        msg = (
            f"{events} update(s) had total weight < "
            f"{self.config.zero_weight_thresh}; posterior may be unreliable."
        )
        if policy == "error":
            raise RuntimeError(msg)
        elif policy == "warn":
            warnings.warn(msg, ApproximationWarning)
        # 'reset' is handled in the step; 'ignore' is a no-op.

    # -- estimators --------------------------------------------------------

    def est_mean(self):
        return particle_mean(self.particle_weights, self.particle_locations)

    def est_meanfn(self, fn):
        """Σᵢ wᵢ fn(xᵢ) over the leading axis of ``fn``'s output."""
        return torch.tensordot(self.particle_weights,
                               fn(self.particle_locations), dims=([0], [0]))

    def est_entropy(self):
        """−Σ wᵢ log wᵢ."""
        log_w = self.state.particle_log_weights
        return -torch.sum(torch.exp(log_w) * log_w)

    def est_covariance_mtx(self, corr=False):
        cov = particle_covariance_mtx(self.particle_weights,
                                      self.particle_locations)
        if corr:
            std = torch.sqrt(torch.diag(cov))
            cov = cov / torch.outer(std, std)
        return cov

    # -- cluster estimators (host, scikit-learn) ---------------------------

    def est_cluster_moments(self, cluster_opts=None):
        """Yield (label, total weight, mean, covariance) of each DBSCAN
        cluster of the cloud (``clustering.particle_clusters`` with
        ``cluster_opts``), in NumPy f32 on the host, as the JAX package
        does ([unverified] signature against upstream qinfer)."""
        from .clustering import particle_clusters

        w = self.particle_weights.cpu().numpy()
        locs = self.particle_locations.cpu().numpy()
        for label, mask in particle_clusters(locs, w, **(cluster_opts or {})):
            total = w[mask].sum()
            if total <= 0:
                continue
            w_n = w[mask] / total
            mu = w_n @ locs[mask]
            centered = locs[mask] - mu
            yield label, total, mu, (w_n[:, None] * centered).T @ centered

    def est_cluster_metrics(self, cluster_opts=None):
        """The number of clusters, the largest cluster's weight and the
        noise's weight."""
        from .clustering import NOISE

        weights = {label: total for label, total, _, _
                   in self.est_cluster_moments(cluster_opts)}
        clusters = [w for label, w in weights.items() if label != NOISE]
        return {"n_clusters": len(clusters),
                "largest_cluster_weight": max(clusters, default=0.0),
                "noise_weight": weights.get(NOISE, 0.0)}

    # -- credible regions --------------------------------------------------

    def est_credible_region(self, level=0.95, return_outside=False,
                            modelparam_slice=None):
        """The particles of the highest-posterior-density set of mass
        ``level``: weights sorted descending (stable, so tied weights keep
        their order), their cumulative sum cut at ``level``, on the bank's
        device with one host read. With ``return_outside`` also the rest.

        The cumulative sum of the f32 weights runs in f64. The JAX package
        sums in f32 with NumPy, sequentially, which drifts with N: at 2^20
        flat weights its cut lands ~10² particles from the f64 one."""
        w = self.particle_weights
        locs = self.particle_locations
        if modelparam_slice is not None:
            locs = locs[:, modelparam_slice]
        order = torch.sort(w, descending=True, stable=True).indices
        cum = torch.cumsum(w[order].to(torch.float64), dim=0)
        level_t = torch.full((1,), float(level), dtype=torch.float64,
                             device=cum.device)
        n_keep = int(torch.searchsorted(cum, level_t)[0]) + 1
        if return_outside:
            return locs[order[:n_keep]], locs[order[n_keep:]]
        return locs[order[:n_keep]]

    def region_est_hull(self, level=0.95, modelparam_slice=None):
        """(vertices, simplices) of the convex hull of the credible set, on
        the host (scipy); for one parameter ([[lo], [hi]], None)."""
        from scipy.spatial import ConvexHull

        points = self.est_credible_region(
            level, modelparam_slice=modelparam_slice).cpu().numpy()
        if points.shape[1] == 1:
            return np.array([[points.min()], [points.max()]]), None
        hull = ConvexHull(points)
        return points[hull.vertices], hull.simplices

    def region_est_ellipsoid(self, level=0.95, tol=1e-4,
                             modelparam_slice=None):
        """(A, c) of the minimum-volume ellipsoid around the credible
        hull."""
        vertices, _ = self.region_est_hull(level, modelparam_slice)
        return mvee(vertices, tol=tol)

    def in_credible_region(self, points, level=0.95, modelparam_slice=None,
                           method="hpd-hull", tol=1e-4):
        """Whether each point lies in the credible region: "hpd-hull" (the
        hull's Delaunay triangulation) or "hpd-mvee" (its ellipsoid)."""
        points = np.atleast_2d(_host(points))
        if method == "hpd-mvee":
            A, c = self.region_est_ellipsoid(level, tol, modelparam_slice)
            return in_ellipsoid(points, A, c)
        vertices, _ = self.region_est_hull(level, modelparam_slice)
        if vertices.shape[1] == 1:
            lo, hi = vertices.min(), vertices.max()
            return (points[:, 0] >= lo) & (points[:, 0] <= hi)
        from scipy.spatial import Delaunay

        return Delaunay(vertices).find_simplex(points) >= 0

    # -- marginals and plots -----------------------------------------------

    def posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                           range_min=None, range_max=None):
        """(bin centres (res,) f32, density (res,) f64) of the weighted
        histogram of one parameter, on the bank's device.

        The edges are NumPy's (``np.histogram_bin_edges`` on the same
        range, in the particles' dtype) and each particle is binned as
        ``np.histogram`` bins it, the right edge closing the last bin; the
        weights are summed in f64 and rounded to f32, as NumPy's
        ``bincount`` does. ``smoothing`` > 0 filters the density on the
        host (``scipy.ndimage.gaussian_filter1d``, σ in parameter units).
        """
        x = self.particle_locations[:, idx_param]
        w = self.particle_weights
        lo = float(x.min()) if range_min is None else range_min
        hi = float(x.max()) if range_max is None else range_max
        if hi <= lo:
            hi = lo + 1e-6
        edges_np = np.histogram_bin_edges(
            np.zeros(0, np.float32), bins=res, range=(lo, hi))
        edges = torch.from_numpy(edges_np).to(x.device)
        lo32 = torch.tensor(lo, dtype=torch.float32, device=x.device)
        hi32 = torch.tensor(hi, dtype=torch.float32, device=x.device)
        keep = (x >= lo32) & (x <= hi32)
        x, w = x[keep], w[keep]
        idx = ((x - lo32).to(torch.float64) / (hi - lo) * res).to(torch.int64)
        idx = torch.where(idx == res, res - 1, idx)
        idx = torch.where(x < edges[idx], idx - 1, idx)
        idx = torch.where((x >= edges[idx + 1]) & (idx != res - 1), idx + 1,
                          idx)
        counts = torch.zeros(res, dtype=torch.float64, device=x.device)
        counts = counts.index_add_(0, idx, w.to(torch.float64)).to(
            torch.float32)
        db = torch.from_numpy(np.diff(edges_np).astype(np.float64)).to(
            x.device)
        hist = counts.to(torch.float64) / db / counts.sum().to(torch.float64)
        xs = 0.5 * (edges[1:] + edges[:-1])
        if smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            hist = torch.from_numpy(gaussian_filter1d(
                hist.cpu().numpy(), smoothing / (edges_np[1] - edges_np[0])
            )).to(x.device)
        return xs, hist

    def plot_posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                                range_min=None, range_max=None,
                                label_xaxis=True, other_plot_args=None,
                                true_model=None):
        """Plot ``posterior_marginal`` with matplotlib."""
        import matplotlib.pyplot as plt

        xs, ys = self.posterior_marginal(idx_param, res, smoothing,
                                         range_min, range_max)
        line = plt.plot(xs.cpu().numpy(), ys.cpu().numpy(),
                        **(other_plot_args or {}))
        if label_xaxis:
            plt.xlabel(str(self.model.modelparam_names[idx_param]))
        if true_model is not None:
            plt.axvline(_host(true_model).flatten()[idx_param], ls="--")
        return line

    def posterior_mesh(self, idx_param1=0, idx_param2=1, res1=100, res2=100,
                       smoothing=0.01):
        """(mesh1, mesh2, density), each (res2, res1) f32 on the bank's
        device: a weighted Gaussian KDE of two parameters on a grid
        spanning the particles, kernel widths ``smoothing`` × each range.

        The grid and widths are computed on the host from the particles'
        f32 extremes exactly as the JAX package computes them. The sum over
        the particles runs on the device in f32, chunk by chunk: the kernel
        factorises, exp(−(dx² + dy²)/2) = exp(−dx²/2)·exp(−dy²/2), so each
        chunk is one (res2 × chunk) @ (chunk × res1) product and no
        (res2, res1, chunk) block is formed.
        """
        locs = self.particle_locations
        w = self.particle_weights
        x, y = locs[:, idx_param1], locs[:, idx_param2]
        x_min, x_max, y_min, y_max = torch.stack(
            [x.min(), x.max(), y.min(), y.max()]).cpu().numpy()
        xs = np.linspace(x_min, x_max + 1e-9, res1)
        ys = np.linspace(y_min, y_max + 1e-9, res2)
        sx = smoothing * (x_max - x_min + 1e-9)
        sy = smoothing * (y_max - y_min + 1e-9)
        norm = 2 * np.pi * sx * sy
        mx, my = (torch.from_numpy(m).to(locs.device)
                  for m in np.meshgrid(xs, ys))
        xs_t, ys_t = mx[0], my[:, 0]
        sx_t, sy_t = (torch.tensor(s, device=locs.device) for s in (sx, sy))
        z = torch.zeros((res2, res1), dtype=xs_t.dtype, device=locs.device)
        for i in range(0, x.shape[0], _MESH_CHUNK):
            sl = slice(i, i + _MESH_CHUNK)
            dx = (xs_t[None, :] - x[sl, None]) / sx_t  # (chunk, res1)
            dy = (ys_t[None, :] - y[sl, None]) / sy_t  # (chunk, res2)
            gx = torch.exp(-0.5 * dx * dx)
            gy = torch.exp(-0.5 * dy * dy) * w[sl, None]
            z += gy.T @ gx
        return mx, my, z / torch.tensor(norm, device=locs.device)

    def plot_posterior_contour(self, idx_param1=0, idx_param2=1, res1=100,
                               res2=100, smoothing=0.01):
        """Contour plot of ``posterior_mesh`` with matplotlib."""
        import matplotlib.pyplot as plt

        mx, my, z = self.posterior_mesh(idx_param1, idx_param2, res1, res2,
                                        smoothing)
        cs = plt.contour(mx.cpu().numpy(), my.cpu().numpy(), z.cpu().numpy())
        plt.xlabel(str(self.model.modelparam_names[idx_param1]))
        plt.ylabel(str(self.model.modelparam_names[idx_param2]))
        return cs

    def plot_covariance(self, corr=False, param_slice=None, tick_labels=None,
                        tick_params=None):
        """The covariance (or correlation) matrix as an image."""
        import matplotlib.pyplot as plt

        cov = self.est_covariance_mtx(corr=corr).cpu().numpy()
        if param_slice is not None:
            cov = cov[param_slice, param_slice]
        im = plt.imshow(cov, cmap="RdBu", vmin=-np.abs(cov).max(),
                        vmax=np.abs(cov).max())
        plt.colorbar(im)
        return im

    # -- sampling ----------------------------------------------------------

    def sample(self, generator=None, n=1):
        """n draws (n, D) from the posterior cloud, with replacement by
        weight, by the 2⁻³⁰-quantized inverse CDF that PGH draws with.
        ``generator`` defaults to the state's, which the draw advances."""
        from .heuristics import _categorical_draws

        if generator is None:
            generator = self.state.generator
        idx = _categorical_draws(generator,
                                 self.state.particle_log_weights[None], n)[0]
        return self.state.particle_locations[idx]

    def __repr__(self):
        return (f"SMCUpdater(model={type(self.model).__name__}, "
                f"n_particles={self._n_particles}, "
                f"resample_count={self.resample_count})")

    # -- experiment design -------------------------------------------------

    def _design_inputs(self, expparams):
        """(expparams on the bank's device, outcomes). The outcomes are
        enumerated from the expparams as given, so that a host record
        (NumPy, CPU tensors) is enumerated and checked on the host."""
        if isinstance(expparams, np.ndarray) and expparams.dtype.names:
            expparams = pytree_to_expparams(expparams)
        outcomes = self.model.all_outcomes(expparams)
        return _expparams_to(expparams, self.device), outcomes

    def bayes_risk(self, expparams, Q=None):
        """Expected posterior quadratic loss of each candidate (with the
        model's ``Q`` unless given)."""
        expparams, outcomes = self._design_inputs(expparams)
        if Q is None:
            Q = getattr(self.model, "Q", None)
        risk = bayes_risk_fn(self.model, self.state, expparams, Q, outcomes)
        return risk[0] if risk.shape[0] == 1 else risk

    def expected_information_gain(self, expparams):
        """Mutual information between the outcome and the parameters,
        per candidate."""
        expparams, outcomes = self._design_inputs(expparams)
        ig = expected_information_gain_fn(self.model, self.state, expparams,
                                          outcomes)
        return ig[0] if ig.shape[0] == 1 else ig


def _bim_increment(model, locs, log_w, expparams, outcomes):
    """Σ_n w_n Σ_e F(θ_n; e): the bank-averaged Fisher information (D, D),
    with the score zeroed where L ≤ 1e-10 (a particle on a likelihood zero
    has a 0/0 score and a Fisher term whose L → 0 limit is finite)."""
    L = model.likelihood(outcomes, locs, expparams)  # (O, N, E)
    sc = DifferentiableModel.score(model, outcomes, locs, expparams)
    sc = torch.where(L[None] > 1e-10, sc, 0.0)  # (D, O, N, E)
    fi = torch.einsum("one,ione,jone->ijne", L, sc, sc)
    return torch.einsum("n,ijne->ij", torch.exp(log_w), fi)


class SMCUpdaterBCRB(SMCUpdater):
    """An ``SMCUpdater`` that also tracks the Bayesian Cramér–Rao bound.

    Each ``update`` first adds the bank-averaged Fisher information of the
    experiment to the Bayesian information matrix ``current_bim``: over the
    current posterior when ``adaptive`` (the default), over the initial
    prior otherwise. ``current_bcrb`` is its inverse. ``initial_bim`` (a
    (D, D) array, e.g. the JAX updater's ``current_bim`` as NumPy) starts
    the matrix. ``batch_update`` accumulates nothing, as in the JAX
    package, unless resampling is eager (then it replays through
    ``update``).
    """

    def __init__(self, *args, initial_bim=None, adaptive=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.adaptive = bool(adaptive)
        d = self.model.n_modelparams
        self._current_bim = (
            torch.zeros((d, d), dtype=torch.float32, device=self.device)
            if initial_bim is None
            else torch.as_tensor(np.asarray(initial_bim), dtype=torch.float32,
                                 device=self.device))
        self._initial_prior_locs = self.state.particle_locations
        self._initial_prior_log_w = self.state.particle_log_weights

    @property
    def current_bim(self):
        return self._current_bim

    @property
    def current_bcrb(self):
        return torch.linalg.inv(self._current_bim)

    def update(self, outcome, expparams, check_for_resample=True):
        expparams_1 = _as_single_expparams(expparams, self.device)
        if self.adaptive:
            locs = self.state.particle_locations
            log_w = self.state.particle_log_weights
        else:
            locs, log_w = self._initial_prior_locs, self._initial_prior_log_w
        outcomes = self.model.all_outcomes(expparams_1)
        self._current_bim = self._current_bim + _bim_increment(
            self.model, locs, log_w, expparams_1, outcomes)
        return super().update(outcome, expparams, check_for_resample)


class MixedApproximateSMCUpdater(SMCUpdater):
    """Updates with ``approximate_model`` while the posterior is broad and
    with ``good_model`` from the first update whose pre-update ESS is below
    ``mixture_thresh``·N (the JAX package's criterion, [unverified] against
    upstream qinfer). ``self.model`` is swapped at the switch; nothing in
    the step keeps a model-specific object across updates."""

    def __init__(self, good_model, approximate_model, n_particles, prior,
                 mixture_thresh=0.5, **kwargs):
        self.good_model = good_model
        self.approximate_model = approximate_model
        self.mixture_thresh = float(mixture_thresh)
        self._sharpened = False
        super().__init__(approximate_model, n_particles, prior, **kwargs)

    def update(self, outcome, expparams, check_for_resample=True):
        if not self._sharpened and (
                float(self.n_ess) < self.mixture_thresh * self.n_particles):
            self._sharpened = True
        self.model = (self.good_model if self._sharpened
                      else self.approximate_model)
        return super().update(outcome, expparams, check_for_resample)


def _gaussian_kl(w0, locs0, w1, locs1):
    """KL(N(μ0, Σ0) ‖ N(μ1, Σ1)) between the moment-matched Gaussians of
    two weighted clouds, on the host in f64: the resampling-divergence
    estimator of the JAX package ([unverified] against upstream qinfer)."""
    d = locs0.shape[1]

    def moments(w, locs):
        mu = w @ locs
        centered = locs - mu
        cov = (w[:, None] * centered).T @ centered
        return mu, cov + 1e-12 * np.eye(d)

    mu0, cov0 = moments(w0, locs0)
    mu1, cov1 = moments(w1, locs1)
    cov1_inv = np.linalg.inv(cov1)
    dmu = mu1 - mu0
    _, logdet0 = np.linalg.slogdet(cov0)
    _, logdet1 = np.linalg.slogdet(cov1)
    return float(0.5 * (np.trace(cov1_inv @ cov0) + dmu @ cov1_inv @ dmu
                        - d + logdet1 - logdet0))


def _host(x):
    """x (a tensor on any device, or array-like) as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_f64(t):
    """A tensor as a host f64 array (f32 values widened exactly)."""
    return t.detach().cpu().numpy().astype(np.float64)


def _as_single_expparams(expparams, device):
    """One experiment's parameters with leading axis E=1, on ``device``."""
    expparams = _expparams_to(expparams, device)
    if isinstance(expparams, dict):
        return {k: v.reshape(1) if v.ndim == 0 else v
                for k, v in expparams.items()}
    return expparams.reshape(1) if expparams.ndim == 0 else expparams


def _expparams_numpy(expparams):
    if isinstance(expparams, dict):
        return {k: v.cpu().numpy() for k, v in expparams.items()}
    return expparams.cpu().numpy()
