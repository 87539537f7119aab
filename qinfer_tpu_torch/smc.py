"""SMC inference engine on torch tensors.

Counterpart of ``qinfer_tpu/smc.py``: ``SMCState``, ``SMCConfig``,
``init_smc_state``, ``smc_update_step``, ``smc_batch_update`` and the
stateful ``SMCUpdater``. The bank keeps log-space f32 weights on one
device; randomness comes from the ``torch.Generator`` carried in the state.

Control flow runs on the host. The JAX package's ``lax.cond`` on
ESS < threshold·N becomes an ``if`` on the ESS, which costs one device→host
sync per update; its ``lax.scan`` over the record becomes a Python loop.
On CUDA the Bayes update runs kernel B1 and the resample kernel B2.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._exceptions import ApproximationWarning
from .distributions import Distribution, ParticleDistribution
from .models.base import Simulatable
from .resamplers import LiuWestResampler
from .utils import effective_sample_size, particle_covariance_mtx, particle_mean

__all__ = [
    "SMCState", "SMCConfig", "SMCUpdater", "init_smc_state",
    "smc_update_step", "smc_batch_update",
]

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


def _uniform_log_weights(n, device):
    return torch.full((n,), -math.log(n), dtype=torch.float32, device=device)


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


def resample_state(model, resampler, state: SMCState) -> SMCState:
    """The state after one resample: new locations, uniform weights."""
    new_locs = resampler(state.generator, model, state.particle_locations,
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


def smc_update_step(model, resampler, config: SMCConfig, state: SMCState,
                    outcome, expparams):
    """One Bayes update + conditional resample.

    Returns (new_state, log_norm) with log_norm the single-update evidence
    log Pr(outcome | expparam) as a 0-d tensor.
    """
    log_w = state.particle_log_weights
    locs = state.particle_locations
    device = log_w.device
    outcome_arr = torch.as_tensor(outcome, device=device).reshape(-1)[:1]
    use_fused = getattr(model, "fused_update_supported", False) and (
        config.use_fused_update
        if config.use_fused_update is not None
        else log_w.is_cuda
    )
    if use_fused:
        log_w_norm, log_norm, ess = model.fused_update(
            outcome_arr[0], log_w, locs, expparams
        )
    else:
        log_L = model.log_likelihood(outcome_arr, locs, expparams)[0, :, 0]
        log_L = torch.clamp(log_L, min=_LOG_TINY)  # lower only
        log_w_new = log_w + log_L
        # One shared max feeds both reductions: ESS = s1²/s2.
        m = torch.max(log_w_new)
        shifted = torch.exp(log_w_new - m)
        s1 = torch.sum(shifted)
        s2 = torch.sum(shifted * shifted)
        log_norm = m + torch.log(s1)
        log_w_norm = log_w_new - log_norm
        ess = s1 * s1 / s2

    n = log_w.shape[0]
    is_zero = log_norm < math.log(config.zero_weight_thresh)
    if config.zero_weight_policy == "reset":
        log_w_norm = torch.where(is_zero, _uniform_log_weights(n, device),
                                 log_w_norm)
        ess = torch.where(is_zero, torch.full((), float(n), device=device), ess)
    state = dataclasses.replace(
        state,
        particle_log_weights=log_w_norm,
        log_total_likelihood=state.log_total_likelihood + log_norm,
        min_n_ess=torch.minimum(state.min_n_ess, ess),
        n_zero_weight_events=state.n_zero_weight_events + is_zero.to(
            torch.int32),
    )

    # The one host sync of the step (lax.cond in the JAX package).
    if bool(ess < config.resample_thresh * n):
        state = resample_state(model, resampler, state)
    else:
        state = dataclasses.replace(
            state, just_resampled=torch.zeros((), dtype=torch.bool,
                                              device=device))

    # Time-dependent models diffuse the cloud after the update; skipped
    # for static models.
    if type(model).update_timestep is not Simulatable.update_timestep:
        new_locs = model.update_timestep(
            state.particle_locations, expparams, generator=state.generator
        )[:, :, 0]
        state = dataclasses.replace(state, particle_locations=new_locs)

    return state, log_norm


def _expparams_to(expparams, device):
    if isinstance(expparams, dict):
        return {k: torch.as_tensor(v, device=device)
                for k, v in expparams.items()}
    return torch.as_tensor(expparams, device=device)


def _expparams_row(expparams, i):
    if isinstance(expparams, dict):
        return {k: v[i:i + 1] for k, v in expparams.items()}
    return expparams[i:i + 1]


def smc_batch_update(model, resampler, config: SMCConfig, state: SMCState,
                     outcomes, expparams):
    """Run the update step over a record of T experiments.

    ``outcomes``: (T,); ``expparams``: tensor or dict of tensors with
    leading axis T (each step sees a single-experiment slice, E=1).
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


# ---------------------------------------------------------------------------
# Stateful host wrapper — reference API surface
# ---------------------------------------------------------------------------

class SMCUpdater(ParticleDistribution):
    """Sequential-Monte-Carlo Bayesian updater.

    Same constructor as the JAX package's ``SMCUpdater`` (less
    ``track_resampling_divergence``), plus ``device`` and an optional
    ``generator`` (which then fixes the device) in place of ``key``.
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
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        device="cpu",
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

        self.data_record = []
        self.normalization_record = []
        self._call_count = 0

        if generator is None:
            generator = torch.Generator(device=torch.device(device))
            generator.manual_seed(seed)
        self.device = generator.device
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

    # -- updates -----------------------------------------------------------

    def update(self, outcome, expparams, check_for_resample=True):
        """One Bayes update (+ conditional resample).
        ``check_for_resample=False`` skips the resample for this call."""
        config = self.config if check_for_resample else self._no_resample_config
        expparams = _as_single_expparams(expparams, self.device)
        prev_zero = int(self.state.n_zero_weight_events)
        self.state, log_norm = smc_update_step(
            self.model, self.resampler, config, self.state, outcome, expparams
        )
        self._call_count += self._n_particles
        self.data_record.append(
            (np.asarray(torch.as_tensor(outcome).cpu()),
             _expparams_numpy(expparams))
        )
        self.normalization_record.append(float(torch.exp(log_norm)))
        self._check_zero_weight(prev_zero)
        return self

    def batch_update(self, outcomes, expparams):
        """Replay a record of T experiments."""
        expparams = _expparams_to(expparams, self.device)
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
        """Force a resample now."""
        self.state = resample_state(self.model, self.resampler, self.state)
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

    def est_covariance_mtx(self, corr=False):
        cov = particle_covariance_mtx(self.particle_weights,
                                      self.particle_locations)
        if corr:
            std = torch.sqrt(torch.diag(cov))
            cov = cov / torch.outer(std, std)
        return cov


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
