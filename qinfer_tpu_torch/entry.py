"""Entry points: one update step of the flagship workload, and a dry run
of every sharded path.

Counterpart of ``__graft_entry__.py``. ``entry`` returns the step and its
arguments, as the JAX package returns a jittable function; here ``fn`` is
the eager step, which launches kernels B1 (and, when it resamples, B2) on
the card. ``dryrun_multichip`` runs inside a process group that the caller
started, as the whole ``parallel`` layer does: every rank calls it with
the same particle mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .distributions import UniformDistribution
from .heuristics import PGH
from .models import GaussianRandomWalkModel, SimplePrecessionModel
from .parallel import (
    PARTICLE_AXIS,
    TRIAL_AXIS,
    host_local_mesh,
    make_sharded_adaptive_episode,
    make_sharded_expdesign,
    make_sharded_greedy_propose,
    make_sharded_pgh_propose,
    make_sharded_update_step,
    shard_episode_keys,
    shard_state,
)
from .perf_testing import run_episodes
from .resamplers import LiuWestResampler
from .smc import SMCConfig, init_smc_state, resolve_device, smc_update_step

__all__ = ["entry", "dryrun_multichip"]

N_ENTRY = 100_000


def entry(device=None):
    """``(fn, (state, outcome, expparams))``: one SMC Bayes update +
    conditional Liu–West resample step (``smc_update_step``) on the
    flagship workload (``SimplePrecessionModel``, U[0, 1], BASELINE config
    1) at 100 000 particles, outcome 1 at t = 2. The state is drawn from a
    ``torch.Generator`` seeded 0 on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device("cuda" if device is None else device)
    model = SimplePrecessionModel()
    resampler = LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")
    generator = torch.Generator(device=device).manual_seed(0)
    state = init_smc_state(generator, model, N_ENTRY,
                           UniformDistribution([0.0, 1.0]))
    outcome = torch.tensor(1, dtype=torch.int32, device=device)
    expparams = {"t": torch.tensor([2.0], device=device)}

    def fn(state, outcome, expparams):
        return smc_update_step(model, resampler, config, state, outcome,
                               expparams)

    return fn, (state, outcome, expparams)


def _require(ok, what):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _finite(x):
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def dryrun_multichip(mesh):
    """One pass over every sharded path on tiny shapes (16 particles a
    rank), each checked as ``__graft_entry__.dryrun_multichip`` checks it:
    the step and a forced resample on a sharded bank, the step with the
    all-gather and the ring migration, sharded Bayes risk and EIG over
    three candidates, the adaptive episode with the greedy EIG and the PGH
    proposes, a time-dependent model through the sharded step, and, at
    two ranks or more, independent episodes on the trials axis of
    ``host_local_mesh``. ``mesh``: the particle mesh over every rank
    (``make_particle_mesh``). Raises AssertionError on a failed check;
    returns what it checked, the same on every rank."""
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size(mesh.get_group(PARTICLE_AXIS))
    n_particles = 16 * world
    model = SimplePrecessionModel()
    prior = UniformDistribution([0.0, 1.0])
    resampler = LiuWestResampler(maxiter=2)
    config = SMCConfig(zero_weight_policy="reset")
    force = SMCConfig(resample_thresh=1.1, zero_weight_policy="reset")
    ep = {"t": torch.tensor([1.0], device=device)}

    def bank(seed, m=model, p=prior):
        """This rank's block of a bank drawn alike on every rank, with a
        generator replicated alike."""
        g = torch.Generator(device=device).manual_seed(seed)
        return shard_state(init_smc_state(g, m, n_particles, p), mesh)

    out = {"world_size": world, "n_particles": n_particles}

    # 1) The step on the sharded bank, then a forced resample.
    step = make_sharded_update_step(mesh, model, resampler, config)
    state, log_norm = step(bank(0), 0, ep)
    _require(_finite(log_norm), "the step's log_norm is not finite")
    forced = make_sharded_update_step(mesh, model, resampler, force)
    resampled, _ = forced(state, 1, ep)
    _require(int(resampled.n_resamples) >= 1, "the forced step did not "
             "resample")
    out["step"] = {"log_norm": float(log_norm),
                   "n_resamples": int(resampled.n_resamples)}

    # 2) Both migrations of the distributed resample, one resample each.
    banks = {}
    for seed, migration, outcome in ((2, "all_gather", 1), (3, "ring", 0)):
        banks[migration], _ = make_sharded_update_step(
            mesh, model, resampler, force, migration=migration)(
            bank(seed), outcome, ep)
        n_res = int(banks[migration].n_resamples)
        _require(n_res == 1, f"the {migration} step made {n_res} resamples, "
                 "expected 1")
        out[migration] = n_res

    # 2b) Sharded Bayes risk and EIG over three candidates.
    risk_fn, eig_fn = make_sharded_expdesign(mesh, model)
    cand = {"t": torch.tensor([1.0, 3.0, 7.0], device=device)}
    for name, score in (("risk", risk_fn(banks["all_gather"], cand)),
                        ("eig", eig_fn(banks["all_gather"], cand))):
        _require(score.shape == (3,) and _finite(score),
                 f"{name} is not finite of shape (3,): {score}")
        out[name] = score.tolist()

    # 2b') The closed adaptive loop with each propose.
    true_mp = np.array([[0.6]], np.float32)
    for name, propose in (
            ("episode_greedy", make_sharded_greedy_propose(mesh, model, cand)),
            ("episode_pgh", make_sharded_pgh_propose(mesh))):
        episode = make_sharded_adaptive_episode(mesh, model, resampler,
                                                config, propose, true_mp, 3)
        _, recs = episode(bank(6),
                          torch.Generator(device=device).manual_seed(7))
        _require(_finite(recs["est_mean"]), f"{name}: est_mean not finite")
        _require(recs["log_norm"].shape == (3,),
                 f"{name}: log_norm of shape {tuple(recs['log_norm'].shape)}")
        out[name] = recs["est_mean"][:, 0].tolist()

    # 2c) A time-dependent model through the sharded step.
    td_model = GaussianRandomWalkModel(model, diagonal=True)
    td_prior = UniformDistribution([[0.0, 1.0], [0.001, 0.05]])
    td_state, _ = make_sharded_update_step(mesh, td_model, resampler,
                                           config)(
        bank(4, td_model, td_prior), 1, ep)
    _require(_finite(td_state.particle_locations),
             "the time-dependent step's cloud is not finite")
    out["time_dependent"] = True

    # 3) The trials axis: each rank runs its block of 2·world episodes.
    if world >= 2:
        emesh = host_local_mesh(n_trials_axis=world,
                                device_type=mesh.device_type)
        seeds = shard_episode_keys(np.arange(2 * world), emesh)
        recs, _ = run_episodes(model, PGH(None).core, resampler, config,
                               prior, None, prior, 32, 4, len(seeds),
                               torch.Generator(device=device).manual_seed(
                                   1 + int(seeds[0])))
        loss = torch.as_tensor(recs["loss"], device=device)
        group = emesh.get_group(TRIAL_AXIS)
        parts = [torch.empty_like(loss)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, loss, group=group)
        loss = torch.cat(parts)
        _require(tuple(loss.shape) == (2 * world, 4),
                 f"trials-axis loss of shape {tuple(loss.shape)}")
        out["trials_loss_shape"] = list(loss.shape)
    return out
