"""The SMC step over a particle bank spread across the ranks of a process
group, with explicit collectives.

Counterpart of ``qinfer_tpu/parallel/sharded_smc.py``. The JAX package's
``shard_map`` bodies are plain functions here, which every rank of a
``torch.distributed`` process group runs over its own contiguous block of
the bank (``mesh.shard_state``). Its collectives map one to one:

- ``psum`` → ``all_reduce(SUM)``; ``pmax`` / ``pmin`` → ``MAX`` / ``MIN``;
- ``all_gather`` → ``dist.all_gather`` (into a list: every torch version
  in use has it);
- ``ppermute`` → ``dist.batch_isend_irecv`` around the ring;
- ``axis_index`` / ``axis_size`` → the group's rank and size.

A ``group`` argument (the mesh's ``particles`` group in the ``make_*``
builders) takes the place of ``axis_name``. The JAX package's other
sharded path, a plain ``jit(smc_update_step)`` over a sharded state
(GSPMD), has no counterpart: the torch counterpart of a sharded state is
the rank's block, and the step below is the one sharded step.

Every branch (resample or not, the zero-weight reset, the postselection
loop, ``migration="auto"``) is decided from all-reduced values or from
shapes, so every rank takes it and the collectives stay matched.

Randomness. The state's generator is replicated: seeded alike on every
rank and consumed by the same calls on every rank, it draws the stratum
offset u0, the rank seeds below, the time step's noise, the greedy
tie-break and the episode's simulation. The draws that differ between
ranks (the Liu–West smear, the postselection redraws, the Gumbel noise of
``sharded_sample``) come from a generator of the rank's own, seeded from
one draw of the replicated generator and the rank.

On CUDA the Bayes update of each block is kernel B1 with its raw
statistics (``return_stats``), merged across ranks by a max and a sum of
the per-rank log-sum-exps, and the all-gather migration picks the rank's
window of strata with kernel B2 over the gathered bank. The ring
migration uses neither B2 nor the gathered bank (it picks through
``K − 1`` ring shifts, as the JAX package does in its ``K`` permutes, the
last of which only brings each block home). The all-gather's picks are
one bank's bit for bit below 2^24 rows: every rank computes the starts
from the gathered log-weights as one bank does. The ring, which never
holds them all, normalizes the weights by an all-reduced max and f64
sum, and so picks as one bank does unless that normalizer and one bank's
f32 ``logsumexp`` quantize a weight apart.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from ..ops.fused_update import fused_bayes_update
from ..ops.resample_expand import (
    _CDF_QUANT,
    _affine,
    _as_u0,
    expand_plain,
    expand_sorted_segments,
    systematic_segment_starts,
)
from ..smc import (
    _LOG_TINY,
    SMCConfig,
    SMCState,
    _expparams_to,
    _is_time_dependent,
    _outcome_rows,
    _pmax,
    _psum,
    _recorded,
    _b1_spec,
    _zero_weight_reset,
    bayes_risk_fn,
    expected_information_gain_fn,
)
from .mesh import PARTICLE_AXIS

__all__ = [
    "global_logsumexp",
    "sharded_moments",
    "sharded_ess",
    "distributed_systematic_pick",
    "distributed_systematic_pick_ring",
    "make_sharded_update_step",
    "make_sharded_expdesign",
    "make_sharded_greedy_propose",
    "make_sharded_pgh_propose",
    "make_sharded_adaptive_episode",
    "sharded_sample",
]

# Per-rank byte budget above which migration='auto' takes the ring in
# place of one all-gather of the bank (64 MB, as in the JAX package).
_RING_MIGRATION_BYTES = 64 * 1024 * 1024

# One bank's starts and kernel B2 carry starts in f32: exact below 2^24.
_EXACT_STARTS_ROWS = 1 << 24


def _all_gather(x, group):
    """(K, *x.shape): ``x`` of every rank of ``group``, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _ring_shift(x, group):
    """``x`` of the previous rank of ``group``'s ring (rank − 1), this
    rank's sent to the next."""
    ranks = dist.get_process_group_ranks(group)
    k, me = len(ranks), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + 1) % k], group),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % k], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _rank_generator(generator, group):
    """A generator of this rank's own on ``generator``'s device, seeded
    from one draw of the replicated ``generator`` (a host read) and the
    rank: the ranks' streams differ, and every rank consumes the
    replicated generator alike."""
    device = generator.device
    base = int(torch.randint(0, 1 << 62, (), generator=generator,
                             device=device))
    return torch.Generator(device=device).manual_seed(
        (base + dist.get_rank(group)) % (1 << 63))


def global_logsumexp(x, group):
    """log-sum-exp of ``x`` over every rank: a max, then a sum."""
    m = _pmax(torch.amax(x), group)
    return m + torch.log(_psum(torch.sum(torch.exp(x - m)), group))


def _merge_lse(lse_local, group):
    """The global log-sum-exp from each rank's: the associative merge of
    kernel B1's raw statistics."""
    m = _pmax(lse_local, group)
    return m + torch.log(_psum(torch.exp(lse_local - m), group))


def sharded_ess(log_w_shard, group):
    lse = global_logsumexp(log_w_shard, group)
    lse2 = global_logsumexp(2.0 * log_w_shard, group)
    return torch.exp(-(lse2 - 2.0 * lse))


def sharded_moments(log_w_shard, locs_shard, group):
    """Globally normalized weighted (mean, covariance), centered, by
    all-reduced sums."""
    lse = global_logsumexp(log_w_shard, group)
    w = torch.exp(log_w_shard - lse)
    mu = _psum(w @ locs_shard, group)
    centered = locs_shard - mu[None, :]
    cov = _psum(torch.einsum("i,id,ie->de", w, centered, centered), group)
    return mu, 0.5 * (cov + cov.T)


def _cdf_log_norm(log_w_shard, group):
    """log Σ exp(log_w) over every rank's block, the normalizer of the
    ring's integer CDF: the max, then the sum of exp(log_w − max) in f64,
    both all-reduced, rounded to f32 once. In f64 the order of the sums
    moves it by ≈ 1e-16 only, so the ring's starts do not depend on how
    the bank is split."""
    m = _pmax(torch.amax(log_w_shard), group).to(torch.float64)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = _psum(torch.sum(torch.exp(log_w_shard.to(torch.float64) - m)), group)
    return (m + torch.log(s)).to(torch.float32)


def _sharded_segment_starts(log_w_shard, group, u0):
    """This rank's global segment starts of systematic resampling (int32,
    (n_local,)), from K scalars of the other ranks: the ring's starts.

    The integer-quantized CDF of ``resamplers.systematic_segment_starts``:
    the weights are normalized by ``_cdf_log_norm`` over every rank,
    quantized to 2⁻³⁰ and summed exactly in int64; the K ranks' totals are
    all-gathered for the exclusive prefix, so the concatenated starts are
    sorted by construction across the ranks. They equal one bank's with
    the same ``u0`` unless the normalizer, which one bank takes from its
    f32 ``logsumexp``, moves a start by one.
    """
    n_global = log_w_shard.shape[0] * dist.get_world_size(group)
    w = torch.exp(log_w_shard - _cdf_log_norm(log_w_shard, group))
    local_icdf = torch.cumsum(torch.round(w * _CDF_QUANT).to(torch.int64), 0)
    totals = _all_gather(local_icdf[-1:], group)[:, 0]  # (K,)
    prefix = (torch.cumsum(totals, 0) - totals)[dist.get_rank(group)]
    scale = torch.full((), float(n_global), device=local_icdf.device) / (
        torch.clamp(torch.sum(totals), min=1).to(torch.float32))
    t = torch.ceil((prefix + local_icdf).to(torch.float32) * scale - u0)
    t_prev_last = torch.ceil(prefix.to(torch.float32) * scale - u0)
    starts = torch.cat([t_prev_last[None], t[:-1]])
    return torch.clamp(starts, min=0.0).to(torch.int32)


def distributed_systematic_pick(generator, log_w_shard, locs_shard, group,
                                use_expand_kernel=False, u0=None, scale=None,
                                shift=None):
    """This rank's n_local rows of a systematic resample of the whole bank,
    (n_local, D), optionally affine-transformed (``scale``/``shift`` as in
    ``expand_sorted_segments``): one bank's picks, bit for bit.

    Migration is one all-gather of the log-weights and one of the bank.
    Every rank computes the bank's segment starts as one bank does
    (``resamplers.systematic_segment_starts``); the log-weights cost the
    bytes that the JAX package's all-gather of the starts does. The rank's
    window of strata [k·n_local, (k+1)·n_local) is picked from the
    gathered bank with the starts shifted by the window's origin and
    clamped at 0: v[max{j : s_j ≤ i + s0}] = v[max{j : max(s_j − s0, 0) ≤
    i}]. ``use_expand_kernel``: True takes kernel B2's wrapper (n_in = N,
    n_out = n_local; its plain version on a CPU bank), False the plain
    pick, as in the JAX package (the step passes its resampler's choice).
    A bank of 2^24 rows or more, which one bank refuses (its f32 starts
    are inexact there), gathers the ring's starts
    (``_sharded_segment_starts``) and takes the plain pick, as the JAX
    package does. ``u0`` is drawn from the replicated ``generator`` unless
    given.
    """
    n_local, d = locs_shard.shape
    device = locs_shard.device
    n_global = n_local * dist.get_world_size(group)
    u0 = _as_u0(u0, (), generator, device)
    exact = n_global < _EXACT_STARTS_ROWS
    if exact:
        starts_all = systematic_segment_starts(
            _all_gather(log_w_shard, group).reshape(n_global), n_global, u0)
    else:
        starts_all = _all_gather(_sharded_segment_starts(
            log_w_shard, group, u0), group).reshape(n_global)
    locs_all = _all_gather(locs_shard, group).reshape(n_global, d)
    shifted = torch.clamp(starts_all - dist.get_rank(group) * n_local, min=0)
    if use_expand_kernel and exact:
        return expand_sorted_segments(shifted, locs_all, n_out=n_local,
                                      scale=scale, shift=shift)
    return expand_plain(shifted, locs_all, n_local,
                        _affine(scale, shift, d, device))


def distributed_systematic_pick_ring(generator, log_w_shard, locs_shard,
                                     group, u0=None, scale=None, shift=None):
    """``distributed_systematic_pick`` by ring migration: no rank ever
    holds more than two blocks of the bank.

    Two rounds of K − 1 ring shifts (the JAX package makes K, the last of
    which only brings each block home): first the blocks of starts, each
    rank scatter-maxing the visiting block's global particle ids into its
    own window and resolving every stratum's particle with one running
    max; then the blocks of locations, each rank taking the rows whose
    particle the visiting block holds. The starts come from
    ``_sharded_segment_starts``, so the picks are the all-gather's unless
    the ring's f64 normalizer and one bank's f32 ``logsumexp`` quantize a
    weight apart (PERF.md, ROADMAP Queue C).
    """
    n_local, d = locs_shard.shape
    device = locs_shard.device
    k, me = dist.get_world_size(group), dist.get_rank(group)
    u0 = _as_u0(u0, (), generator, device)
    starts_local = _sharded_segment_starts(log_w_shard, group, u0)
    my_s0 = me * n_local
    local_ids = torch.arange(n_local, dtype=torch.int64, device=device)

    # Slot n_local collects the sources past the window (dropped).
    z = torch.zeros(n_local + 1, dtype=torch.int64, device=device)
    blk = starts_local
    for r in range(k):
        rel = blk.to(torch.int64) - my_s0
        pos = torch.where(rel < n_local, torch.clamp(rel, min=0), n_local)
        z.scatter_reduce_(0, pos, ((me - r) % k) * n_local + local_ids,
                          "amax")
        if r < k - 1:
            blk = _ring_shift(blk, group)
    idx = torch.cummax(z[:n_local], 0).values  # global particle ids

    out = torch.zeros_like(locs_shard)
    blk = locs_shard
    for r in range(k):
        rel = idx - ((me - r) % k) * n_local
        mine = (rel >= 0) & (rel < n_local)
        out = torch.where(mine[:, None],
                          blk[torch.clamp(rel, 0, n_local - 1)], out)
        if r < k - 1:
            blk = _ring_shift(blk, group)
    affine = _affine(scale, shift, d, device)
    return out if affine is None else out * affine[0:1] + affine[1:2]


def _migration(migration, n_global, d):
    if migration == "auto":
        gathered = n_global * 4 * (1 + d)
        return "ring" if gathered > _RING_MIGRATION_BYTES else "all_gather"
    return migration


def _sharded_resample(model, resampler, generator, locs, log_w, group,
                      migration):
    """The Liu–West resample of this rank's block, through the resampler's
    own steps: its moments from the sharded ones, the distributed pick
    with its shrinkage affine, its smear from the rank's own generator and
    its postselection while any rank holds an invalid row (one all-reduce
    and host read a test)."""
    n_local, d = locs.shape
    mu, _, S = resampler._moments(
        log_w, locs, functools.partial(sharded_moments, group=group))
    scale, shift = resampler._shrinkage(mu)
    n_global = n_local * dist.get_world_size(group)
    if _migration(migration, n_global, d) == "ring":
        centers = distributed_systematic_pick_ring(
            generator, log_w, locs, group, scale=scale, shift=shift)
    else:
        centers = distributed_systematic_pick(
            generator, log_w, locs, group,
            use_expand_kernel=resampler._expand_kernel_on(locs.device),
            scale=scale, shift=shift)

    def counts(bad):  # (this rank's, every rank's) invalid rows: one read
        return tuple(torch.stack([bad, _psum(bad, group)]).tolist())

    return resampler._postselect(
        model, _rank_generator(generator, group), centers, S,
        _all_valid=lambda ok: counts(torch.sum(~ok))[1] == 0,
        _counts=counts)


def make_sharded_update_step(mesh, model, resampler, config: SMCConfig,
                             migration="auto"):
    """The SMC update step over this rank's block of a bank spread along
    the mesh's ``particles`` axis.

    ``migration``: 'auto' (the ring when the gathered starts and bank
    would pass ``_RING_MIGRATION_BYTES`` a rank, else one all-gather),
    'all_gather' or 'ring'.

    Returns ``step(state, outcome, expparams) -> (state, log_norm)``, where
    ``state`` holds the rank's block (``shard_state``) and its replicated
    scalars and generator, which stay replicated. The semantics are
    ``smc.smc_update_step``'s (Bayes update → ESS → conditional Liu–West
    resample, the zero-weight reset, the time step), with the sums over
    the bank all-reduced. Models with a B1 tile run the fused update
    whenever the bank is on CUDA (``SMCConfig.use_fused_update`` forces it
    on or off, as on one bank): B1 with ``return_stats`` on the block,
    then two merges of the raw log-sum-exps give the evidence and the ESS
    (four all-reduces an update; the unfused route takes six).

    A time-dependent model's step draws the noise for the WHOLE bank's
    shape from the replicated generator and keeps the rank's rows: the
    update_timestep runs on K copies of the block, which costs K times the
    noise and the walk's arithmetic, so that a trajectory that does not
    resample moves every particle exactly as one bank does.
    """
    if migration not in ("auto", "all_gather", "ring"):
        raise ValueError(f"unknown migration {migration!r}; expected 'auto', "
                         "'all_gather' or 'ring'")
    group = mesh.get_group(PARTICLE_AXIS)
    time_dependent = _is_time_dependent(model)

    def step(state: SMCState, outcome, expparams):
        locs = state.particle_locations
        log_w = state.particle_log_weights
        device = log_w.device
        n_local = log_w.shape[0]
        k = dist.get_world_size(group)
        n_global = n_local * k
        expparams = _expparams_to(expparams, device)
        outcome_arr = _outcome_rows(
            model, torch.as_tensor(outcome, device=device))[:1]
        spec = _b1_spec(model, config, locs, outcome_arr, expparams)
        if spec is not None:
            lw_new, lse_loc, lse2_loc = fused_bayes_update(
                spec[0], spec[1], log_w, spec[2], return_stats=True)
            log_norm = _merge_lse(lse_loc, group)
            lse2 = _merge_lse(lse2_loc, group)
            lw_norm = lw_new - log_norm
            ess = torch.exp(-(lse2 - 2.0 * log_norm))
        else:
            log_L = torch.clamp(
                model.log_likelihood(outcome_arr, locs, expparams)[0, :, 0],
                min=_LOG_TINY)  # lower only
            lw_new = log_w + log_L
            log_norm = global_logsumexp(lw_new, group)
            lw_norm = lw_new - log_norm
            ess = None

        lw_norm, ess, is_zero = _zero_weight_reset(config, lw_norm, log_norm,
                                                   ess, n_global)
        if ess is None:
            ess = sharded_ess(lw_norm, group)
        # The host read of the step; ess is all-reduced, so every rank
        # takes the same branch.
        need = bool(ess < config.resample_thresh * n_global)
        if need:
            locs = _sharded_resample(model, resampler, state.generator, locs,
                                     lw_norm, group, migration)
            lw_norm = torch.full((n_local,), -math.log(n_global),
                                 dtype=torch.float32, device=device)
        state = _recorded(
            state, log_norm, ess, is_zero,
            particle_locations=locs,
            particle_log_weights=lw_norm,
            n_resamples=state.n_resamples + int(need),
            just_resampled=torch.full((), need, dtype=torch.bool,
                                      device=device),
        )
        if time_dependent:
            me = dist.get_rank(group)
            rows = slice(me * n_local, (me + 1) * n_local)
            walked = model.update_timestep(
                state.particle_locations.repeat(k, 1), expparams,
                generator=state.generator)[rows, :, 0]
            state = dataclasses.replace(state, particle_locations=walked)
        return state, log_norm

    return step


def make_sharded_expdesign(mesh, model):
    """Bayes risk and expected information gain over this rank's block:
    ``smc.bayes_risk_fn`` / ``expected_information_gain_fn`` with the
    mesh's ``particles`` group, every sum over particles all-reduced (the
    streaming statistics one all-reduce each).

    Returns ``(risk, eig)``: ``risk(state, expparams, Q=None,
    outcomes=None) -> (E,)`` (``Q`` defaults to the model's) and
    ``eig(state, expparams, outcomes=None) -> (E,)``, the same on every
    rank. The outcomes are enumerated from the expparams as given, then
    the expparams move to the bank's device.
    """
    group = mesh.get_group(PARTICLE_AXIS)

    def _inputs(state, expparams, outcomes):
        if outcomes is None:
            outcomes = model.all_outcomes(expparams)
        return (_expparams_to(expparams, state.particle_log_weights.device),
                outcomes)

    def risk(state, expparams, Q=None, outcomes=None):
        expparams, outcomes = _inputs(state, expparams, outcomes)
        return bayes_risk_fn(model, state, expparams,
                             getattr(model, "Q", None) if Q is None else Q,
                             outcomes, group=group)

    def eig(state, expparams, outcomes=None):
        expparams, outcomes = _inputs(state, expparams, outcomes)
        return expected_information_gain_fn(model, state, expparams,
                                            outcomes, group=group)

    return risk, eig


def make_sharded_greedy_propose(mesh, model, candidates, use_eig=True,
                                Q=None):
    """Greedy EIG (or risk) pick among ``candidates`` over this rank's
    block: the sharded scores of ``make_sharded_expdesign``, the argmax
    with exact ties broken by ``keyed_tiebreak_argmax`` from the
    replicated generator, so that every rank picks the same candidate.

    Returns ``propose(generator, state) -> expparams`` (fields of leading
    axis 1, on the bank's device).
    """
    from ..heuristics import keyed_tiebreak_argmax

    risk_fn, eig_fn = make_sharded_expdesign(mesh, model)
    cand = {k: torch.as_tensor(v) for k, v in candidates.items()}

    def propose(generator, state):
        device = state.particle_log_weights.device
        ep = {k: v.to(device) for k, v in cand.items()}
        score = eig_fn(state, ep) if use_eig else -risk_fn(state, ep, Q)
        best = keyed_tiebreak_argmax(generator, score)
        return {k: v[best][None] for k, v in ep.items()}

    return propose


def sharded_sample(generator, log_w_shard, locs_shard, n, group):
    """n posterior draws (n, D), the same on every rank, by the Gumbel-max
    trick: each draw is the global argmax of log w + Gumbel noise (drawn
    from the rank's own generator). A tie of the best scores across
    ranks goes to the lowest rank, so that the sum that broadcasts the
    winner counts it once."""
    lw = log_w_shard - global_logsumexp(log_w_shard, group)
    me = dist.get_rank(group)
    rank_gen = _rank_generator(generator, group)
    expo = torch.empty((n,) + lw.shape, device=lw.device).exponential_(
        generator=rank_gen)
    scores = lw[None, :] - torch.log(expo)  # Gumbel: −log of Exp(1)
    best = torch.argmax(scores, dim=1)
    best_val = torch.gather(scores, 1, best[:, None])[:, 0]
    at_max = best_val == _pmax(best_val, group)
    owner = _psum(torch.where(at_max, me, torch.iinfo(torch.int32).max).to(
        torch.int32), group, dist.ReduceOp.MIN)
    mine = (at_max & (owner == me)).to(locs_shard.dtype)
    return _psum(mine[:, None] * locs_shard[best], group)


def make_sharded_pgh_propose(mesh, t_field="t", inv_field=None, t_func=None,
                             inv_func=None, other_fields=None,
                             eps_dist=1e-12):
    """The particle-guess heuristic over this rank's block: two posterior
    draws by ``sharded_sample`` (no gather of the bank), t = t_func(1/‖x₁
    − x₂‖) with the distance floored at ``eps_dist``.

    Returns ``propose(generator, state) -> expparams`` (fields of leading
    axis 1), the same on every rank.
    """
    group = mesh.get_group(PARTICLE_AXIS)
    t_func = t_func if t_func is not None else (lambda x: x)
    inv_func = inv_func if inv_func is not None else (lambda x: x)

    def propose(generator, state):
        x = sharded_sample(generator, state.particle_log_weights,
                           state.particle_locations, 2, group)
        dist_ = torch.linalg.vector_norm(x[0] - x[1])
        t = t_func(1.0 / torch.clamp(dist_, min=eps_dist))
        ep = {t_field: torch.as_tensor(t, dtype=torch.float32).reshape(1)}
        if inv_field is not None:
            ep[inv_field] = inv_func(x[0])[None]
        for name, val in dict(other_fields or {}).items():
            ep[name] = torch.full((1,), float(val), device=x.device)
        return ep

    return propose


def make_sharded_adaptive_episode(mesh, model, resampler, config: SMCConfig,
                                  propose, true_modelparams, n_exp,
                                  migration="auto"):
    """The adaptive loop (design → simulate → update) over this rank's
    block, ``n_exp`` steps: ``propose`` (``make_sharded_greedy_propose``
    or ``make_sharded_pgh_propose``) picks the experiment, the outcome is
    simulated from the true model with the replicated generator, and
    ``make_sharded_update_step`` updates; the truth then takes the model's
    time step (the identity for static models).

    Returns ``episode(state, generator) -> (state, records)``;
    ``generator`` is replicated (seeded alike on every rank). ``records``
    holds ``log_norm`` (n_exp,), ``est_mean`` (n_exp, D), ``true``
    (n_exp, D) and each ``expparams`` field stacked (n_exp, …), on the
    bank's device.
    """
    step = make_sharded_update_step(mesh, model, resampler, config,
                                    migration=migration)
    group = mesh.get_group(PARTICLE_AXIS)

    def episode(state, generator):
        device = state.particle_log_weights.device
        true_mp = torch.atleast_2d(torch.as_tensor(
            true_modelparams, dtype=torch.float32, device=device))
        records = {"log_norm": [], "est_mean": [], "true": [], "expparams": []}
        for _ in range(int(n_exp)):
            ep = propose(generator, state)
            outcome = model.simulate_experiment(generator, true_mp,
                                                ep)[0, 0, 0]
            state, log_norm = step(state, outcome, ep)
            records["log_norm"].append(log_norm)
            records["est_mean"].append(sharded_moments(
                state.particle_log_weights, state.particle_locations,
                group)[0])
            records["true"].append(true_mp[0])
            records["expparams"].append(ep)
            true_mp = model.update_timestep(true_mp, ep,
                                            generator=generator)[:, :, 0]
        eps = records.pop("expparams")
        out = {k: torch.stack(v) for k, v in records.items()}
        out["expparams"] = {k: torch.cat([e[k] for e in eps])
                            for k in eps[0]}
        return state, out

    return episode
