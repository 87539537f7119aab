"""Performance-testing harness on torch tensors.

Counterpart of ``qinfer_tpu/perf_testing.py``: ``timing``, ``perf_test``,
``perf_test_multiple``, ``run_episodes`` and the structured result dtype
(fields ``elapsed_time``, ``loss``, ``resample_count``, ``outcome``,
``true``, ``est``).

One episode step is heuristic → simulate at the true parameters → Bayes
update → record. The JAX package ``vmap``s it over a key axis; here the
trials are a leading axis of one ``SMCState`` (``smc.py``): every step
proposes for all trials at once, simulates each trial at its own true
parameters and experiment, updates all banks with one launch of kernel B1,
reads the resample mask once on the host, and resamples only the trials
that need it (kernel B2, one launch for all of them). One
``torch.Generator`` serves the whole ensemble, so trajectories depend on
the number of trials.

Timing. Both modes first run a short warm-up on another generator (two
experiments and one resample of every trial: it builds the kernels,
initializes the libraries and allocates). ``"aggregate"`` then times one
whole ensemble run and reports (wall time)/(T·n_exp) in ``elapsed_time``,
as the JAX package does. ``"per_update"`` times each experiment round of
all trials, ending in a device sync. Both modes run the same steps on the
same generator, so the same seed gives the same trajectories. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .profiling import span
from .resamplers import LiuWestResampler
from .smc import (
    SMCConfig,
    SMCUpdater,
    _expparams_row,
    _is_time_dependent,
    init_batched_smc_state,
    resolve_device,
    smc_update_step_batched,
)

__all__ = ["perf_test", "perf_test_multiple", "run_episodes", "timing"]

# Experiments of the warm-up run before the timed run.
_WARMUP_EXPERIMENTS = 2
# Offset of the warm-up run's seed (the JAX package folds 0x5EED into its
# keys for its warm-up).
_WARMUP_SEED = 0x5EED


class timing:
    """Context manager timing a block on the host clock."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()

    @property
    def delta_t(self):
        return self.end - self.start


def _resolve_heuristic_core(heuristic_class, updater=None):
    """The pure ``propose`` core of a heuristic class (or partial)."""
    h = heuristic_class(updater)
    if hasattr(h, "core"):
        return h.core
    if hasattr(h, "propose"):
        return h
    raise TypeError(
        "Heuristic must expose a pure propose(generator, state, step_idx)."
    )


def _sync(device):
    if torch.device(device).type == "cuda":
        with span("qinfer.sync.device"):
            torch.cuda.synchronize(device)


def _episode_step(model, heuristic_core, resampler, config, model_sim, q,
                  state, true_mps, step_idx):
    """All trials advance one experiment. Returns (state, true_mps, record
    of (T, …) device tensors)."""
    with span("qinfer.perf_testing.step"):
        with span("qinfer.design.propose"):
            ep = heuristic_core.propose(state.generator, state, step_idx)
        with span("qinfer.perf_testing.simulate"):
            outcomes = model_sim.simulate_trials(state.generator, true_mps,
                                                 ep)
        state, log_norm = smc_update_step_batched(model, resampler, config,
                                                  state, outcomes, ep)
        true_next = true_mps
        if _is_time_dependent(model_sim):
            true_next = torch.stack([
                model_sim.update_timestep(true_mps[i:i + 1],
                                          _expparams_row(ep, i),
                                          generator=state.generator)[0, :, 0]
                for i in range(true_mps.shape[0])
            ])
        with span("qinfer.perf_testing.record"):
            w = torch.exp(state.particle_log_weights)
            est = torch.einsum("tn,tnd->td", w, state.particle_locations)
            delta = est - true_mps[:, :est.shape[1]]
            rec = {
                "loss": torch.sum(q * delta * delta, dim=1),
                "resample_count": state.n_resamples,
                "outcome": outcomes.to(torch.float32),
                "est": est,
                "true": true_mps,
                "log_norm": log_norm,
            }
        return state, true_next, rec


def _episodes_init(model, prior, true_prior, n_trials, n_particles,
                   generator):
    state = init_batched_smc_state(generator, model, n_trials, n_particles,
                                   prior)
    true_mps = true_prior.sample(generator, n_trials).to(torch.float32)
    return state, true_mps


def _stack_records(rec_list):
    """Per-step records → numpy arrays of (T, n_exp, …)."""
    with span("qinfer.sync.records"):
        return {k: torch.stack([r[k] for r in rec_list], dim=1).cpu().numpy()
                for k in rec_list[0]}


def run_episodes(model, heuristic_core, resampler, config, prior,
                 true_model, true_prior, n_particles: int, n_exp: int,
                 n_trials: int, generator):
    """T episodes of n_exp experiments in lockstep. Returns (records dict of
    (T, n_exp, …) numpy arrays, final batched state). ``true_model`` None
    simulates with ``model``."""
    model_sim = true_model if true_model is not None else model
    state, true_mps = _episodes_init(model, prior, true_prior, n_trials,
                                     n_particles, generator)
    q = torch.as_tensor(model.Q, dtype=torch.float32, device=true_mps.device)
    recs = []
    for k in range(n_exp):
        state, true_mps, rec = _episode_step(
            model, heuristic_core, resampler, config, model_sim, q, state,
            true_mps, k)
        recs.append(rec)
    return _stack_records(recs), state


def perf_test(model, n_particles, prior, n_exp, heuristic_class,
              true_model=None, true_prior=None, true_mps=None,
              resampler=None, extra_updater_args=None, seed=0,
              generator=None, timing_mode="aggregate", device="cuda"):
    """One trial; a structured array of shape (n_exp,).

    ``"aggregate"`` runs ``perf_test_multiple`` with one trial;
    ``"per_update"`` drives a host-side ``SMCUpdater`` loop and records each
    update's wall time (ending in a device sync) in ``elapsed_time``.
    ``generator`` (else one seeded with ``seed`` on ``device``) supplies all
    randomness.
    """
    if timing_mode == "per_update":
        return _perf_test_per_update(
            model, n_particles, prior, n_exp, heuristic_class,
            true_model=true_model, true_prior=true_prior, true_mps=true_mps,
            resampler=resampler, extra_updater_args=extra_updater_args,
            seed=seed, generator=generator, device=device,
        )
    result = perf_test_multiple(
        1, model, n_particles, prior, n_exp, heuristic_class,
        true_model=true_model, true_prior=true_prior,
        resampler=resampler, extra_updater_args=extra_updater_args,
        seed=seed, generator=generator, timing_mode=timing_mode,
        device=device,
    )
    return result[0]


def _performance_dtype(d_true, d_est):
    return np.dtype([
        ("elapsed_time", float),
        ("loss", float),
        ("resample_count", int),
        ("outcome", float),
        ("true", float, (d_true,)),
        ("est", float, (d_est,)),
    ])


def _perf_test_per_update(model, n_particles, prior, n_exp, heuristic_class,
                          true_model=None, true_prior=None, true_mps=None,
                          resampler=None, extra_updater_args=None, seed=0,
                          generator=None, device="cuda"):
    if true_model is None:
        true_model = model
    if true_prior is None:
        true_prior = prior
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    device = generator.device
    if true_mps is None:
        true_mps = true_prior.sample(generator, 1).to(torch.float32)
    else:
        true_mps = torch.atleast_2d(torch.as_tensor(
            true_mps, dtype=torch.float32, device=device))
    updater = SMCUpdater(
        model, int(n_particles), prior, resampler=resampler,
        generator=generator,
        **{"zero_weight_policy": "reset", **dict(extra_updater_args or {})},
    )
    heuristic = heuristic_class(updater)
    q = np.asarray(torch.as_tensor(model.Q).cpu(), float).reshape(-1)
    true_np = true_mps[0].cpu().numpy().astype(float)

    out = np.zeros((n_exp,), dtype=_performance_dtype(true_np.shape[0],
                                                      model.n_modelparams))
    for idx in range(n_exp):
        ep = heuristic()
        outcome = true_model.simulate_experiment(generator, true_mps, ep)[0, 0]
        with timing() as t:
            updater.update(outcome, ep)
            _sync(device)
        est = updater.est_mean().cpu().numpy().astype(float)
        out[idx]["elapsed_time"] = t.delta_t
        out[idx]["loss"] = float(q @ ((est - true_np[:est.shape[0]]) ** 2))
        out[idx]["resample_count"] = updater.resample_count
        out[idx]["outcome"] = float(outcome.reshape(-1)[0])
        out[idx]["true"] = true_np
        out[idx]["est"] = est
    return out


def perf_test_multiple(n_trials, model, n_particles, prior, n_exp,
                       heuristic_class, true_model=None, true_prior=None,
                       apply=None, allow_failures=False,
                       extra_updater_args=None, resampler=None,
                       progressbar=None, seed=0, generator=None,
                       return_time=False, timing_mode="aggregate",
                       device="cuda"):
    """Many independent trials in lockstep on one device.

    ``apply`` and ``allow_failures`` (the reference's ipyparallel fan-out)
    are accepted and ignored: the trial axis replaces them.
    ``progressbar``: an object with ``start``/``update``/``finished``,
    started with n_exp and finished at the end; ``"per_update"`` also
    updates it after each experiment round.

    ``timing_mode``: ``"aggregate"`` (``elapsed_time`` is the timed run's
    wall time over T·n_exp) or ``"per_update"`` (each round's wall time
    over T; a distribution over the experiment axis). Returns a structured
    array (n_trials, n_exp) with the reference's fields, and with
    ``return_time`` also the total timed seconds.
    """
    del apply, allow_failures
    if timing_mode not in ("aggregate", "per_update"):
        raise ValueError(
            f"timing_mode must be 'aggregate' or 'per_update', got "
            f"{timing_mode!r}"
        )
    if resampler is None:
        resampler = LiuWestResampler()
    extra = dict(extra_updater_args or {})
    config = SMCConfig(
        resample_thresh=float(extra.pop("resample_thresh", 0.5)),
        zero_weight_policy=extra.pop("zero_weight_policy", "reset"),
        zero_weight_thresh=float(extra.pop("zero_weight_thresh", 1e-10)),
        use_fused_update=extra.pop("use_fused_update", None),
    )
    if true_prior is None:
        true_prior = prior
    heuristic_core = _resolve_heuristic_core(heuristic_class)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    device = generator.device
    args = (model, heuristic_core, resampler, config, prior, true_model,
            true_prior, int(n_particles))

    if progressbar is not None:
        progressbar.start(n_exp)

    # Warm-up on its own generator: builds the kernels and allocates, and
    # leaves the timed run's random stream untouched. Its steps may not
    # resample, so it resamples all trials once more at the end (the
    # resample's libraries initialize on first use at each batch shape).
    warm = torch.Generator(device=device)
    warm.manual_seed(seed + _WARMUP_SEED)
    _, state = run_episodes(*args, min(n_exp, _WARMUP_EXPERIMENTS), n_trials,
                            warm)
    resampler.batched(warm, model, state.particle_locations,
                      state.particle_log_weights)
    _sync(device)

    if timing_mode == "per_update":
        recs, times = _per_update_rounds(*args, int(n_exp), n_trials,
                                         generator, progressbar)
        total = float(times.sum())
        elapsed = times[None, :] / n_trials
    else:
        with timing() as t:
            recs, _ = run_episodes(*args, int(n_exp), n_trials, generator)
        total = t.delta_t
        elapsed = total / (n_trials * n_exp)
    if progressbar is not None:
        progressbar.finished()

    out = _records_to_structured(recs, n_trials, n_exp)
    out["elapsed_time"] = elapsed
    if return_time:
        return out, total
    return out


def _per_update_rounds(model, heuristic_core, resampler, config, prior,
                       true_model, true_prior, n_particles, n_exp, n_trials,
                       generator, progressbar):
    """``run_episodes`` with each round timed to a device sync."""
    model_sim = true_model if true_model is not None else model
    state, true_mps = _episodes_init(model, prior, true_prior, n_trials,
                                     n_particles, generator)
    q = torch.as_tensor(model.Q, dtype=torch.float32, device=true_mps.device)
    recs, times = [], np.zeros(n_exp)
    for k in range(n_exp):
        with timing() as t:
            state, true_mps, rec = _episode_step(
                model, heuristic_core, resampler, config, model_sim, q,
                state, true_mps, k)
            _sync(generator.device)
        times[k] = t.delta_t
        recs.append(rec)
        if progressbar is not None:
            progressbar.update(k + 1)
    return _stack_records(recs), times


def _records_to_structured(recs, n_trials, n_exp):
    out = np.zeros((n_trials, n_exp), dtype=_performance_dtype(
        recs["true"].shape[-1], recs["est"].shape[-1]))
    for name in ("loss", "resample_count", "outcome", "true", "est"):
        out[name] = recs[name]
    return out
