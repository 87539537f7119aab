"""Worker of tests/test_torch_parallel.py: one rank of a gloo process group
on the CPU, running every scenario of the port's sharded layer.

    python tests/_torch_parallel_worker.py <dir> <rank> <world_size>

Reads ``<dir>/inputs.npz`` (written by the test from a numpy seed and the
JAX package's keys), joins the group through a file store in ``<dir>``
(every collective bounded by the group's timeout) and writes each
scenario's results for this rank to ``<dir>/<scenario>_rank<r>.npz``.
Imports the port only, never JAX.
"""

import datetime
import functools
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import _psd_host_kernel  # noqa: E402
import chip_smoke  # noqa: E402
import qinfer_tpu_torch as qt  # noqa: E402
from qinfer_tpu_torch import parallel as par  # noqa: E402
from qinfer_tpu_torch import profiling  # noqa: E402
from qinfer_tpu_torch import tomography as tomo  # noqa: E402
from qinfer_tpu_torch.interop import (  # noqa: E402
    shard_from_numpy,
    state_from_numpy,
)
from qinfer_tpu_torch.ops import psd_valid as pv  # noqa: E402
from qinfer_tpu_torch.parallel import sharded_smc  # noqa: E402

TIMEOUT_S = 60
ROWS_SEEN = []


class CountingPrecession(qt.SimplePrecessionModel):
    """The precession model, noting the rows of each likelihood call."""

    def likelihood(self, outcomes, modelparams, expparams):
        ROWS_SEEN.append(modelparams.shape[0])
        return super().likelihood(outcomes, modelparams, expparams)


def state_arrays(locs, lw):
    """The JAX ``SMCState``'s arrays of a bank (what ``jax.tree_util.tree_map
    (np.asarray, state)`` gives), without its key."""
    return {"particle_locations": locs, "particle_log_weights": lw,
            "n_resamples": np.int32(0), "min_n_ess": np.float32(len(lw)),
            "log_total_likelihood": np.float32(0.0),
            "just_resampled": np.bool_(False),
            "n_zero_weight_events": np.int32(0)}


def scalars(state, log_norm):
    return {"log_norm": log_norm.numpy(),
            "n_resamples": state.n_resamples.numpy(),
            "min_n_ess": state.min_n_ess.numpy(),
            "log_total_likelihood": state.log_total_likelihood.numpy(),
            "just_resampled": state.just_resampled.numpy(),
            "n_zero_weight_events": state.n_zero_weight_events.numpy()}


def main(out, rank, world):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out / 'store'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        run(out, rank, world)
    finally:
        dist.destroy_process_group()


def run(out, rank, world):
    inp = dict(np.load(out / "inputs.npz"))
    mesh = par.make_particle_mesh(device_type="cpu")
    group = mesh.get_group(par.PARTICLE_AXIS)
    n = len(inp["lw"])
    n_local = n // world
    rows = slice(rank * n_local, (rank + 1) * n_local)

    def save(name, **arrays):
        np.savez(out / f"{name}_rank{rank}.npz", **arrays)

    def bank(seed=0, lw=None):
        return shard_from_numpy(state_arrays(
            inp["locs"], inp["lw"] if lw is None else lw), mesh, seed=seed)

    model = qt.SimplePrecessionModel()
    ep = {"t": np.array([5.0], np.float32)}
    for name, fused in (("update_unfused", False), ("update_fused", True)):
        step = par.make_sharded_update_step(
            mesh, model, qt.LiuWestResampler(),
            qt.SMCConfig(resample_thresh=-1.0, use_fused_update=fused))
        state, log_norm = step(bank(), 1, ep)
        save(name, lw=state.particle_log_weights.numpy(),
             **scalars(state, log_norm))

    # The distributed pick, by all three routes, at the test's u0.
    pick_lw = torch.from_numpy(inp["pick_lw"][rows])
    pick_locs = torch.from_numpy(inp["pick_locs"][rows])
    u0 = float(inp["pick_u0"])
    picks = {
        "all_gather": par.distributed_systematic_pick(
            None, pick_lw, pick_locs, group, use_expand_kernel=False, u0=u0),
        "expand": par.distributed_systematic_pick(
            None, pick_lw, pick_locs, group, use_expand_kernel=True, u0=u0),
        "ring": par.distributed_systematic_pick_ring(
            None, pick_lw, pick_locs, group, u0=u0)}
    # The all-gather route past its exact-starts size (2^24 rows, here
    # lowered to the bank's): the ring's starts, the plain pick.
    exact_rows = sharded_smc._EXACT_STARTS_ROWS
    sharded_smc._EXACT_STARTS_ROWS = n
    picks["past_exact"] = par.distributed_systematic_pick(
        None, pick_lw, pick_locs, group, use_expand_kernel=True, u0=u0)
    sharded_smc._EXACT_STARTS_ROWS = exact_rows
    save("pick", **{k: v.numpy() for k, v in picks.items()})

    # A forced resample through the step: each migration, and 'auto' on
    # both sides of its byte budget (the ring's calls counted).
    ring_calls = [0]
    ring = sharded_smc.distributed_systematic_pick_ring

    def counted_ring(*args, **kw):
        ring_calls[0] += 1
        return ring(*args, **kw)

    sharded_smc.distributed_systematic_pick_ring = counted_ring
    forced = qt.SMCConfig(resample_thresh=1.1, zero_weight_policy="reset")
    ep_r = {"t": np.array([0.7], np.float32)}
    migrations = {}
    for name, migration, budget in (
            ("all_gather", "all_gather", None), ("ring", "ring", None),
            ("auto_small", "auto", None), ("auto_ring", "auto", 1)):
        default = sharded_smc._RING_MIGRATION_BYTES
        if budget is not None:
            sharded_smc._RING_MIGRATION_BYTES = budget
        before = ring_calls[0]
        step = par.make_sharded_update_step(
            mesh, model, qt.LiuWestResampler(), forced, migration=migration)
        state, log_norm = step(bank(seed=5, lw=inp["skew_lw"]), 1, ep_r)
        sharded_smc._RING_MIGRATION_BYTES = default
        migrations[name] = state.particle_locations.numpy()
        migrations[name + "_ring_calls"] = np.int64(ring_calls[0] - before)
        save(f"migration_{name}", **scalars(state, log_norm))
    save("migration", **migrations)
    sharded_smc.distributed_systematic_pick_ring = ring

    # A forced resample with and without the smear, and the same update
    # without the resample (the weights the resample saw).
    update = par.make_sharded_update_step(
        mesh, model, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0))
    lw_pre = update(bank(seed=7, lw=inp["skew_lw"]), 0, ep_r)[0]
    for name, resampler in (("resample_h0", qt.LiuWestResampler(h=0.0)),
                            ("resample_smear", qt.LiuWestResampler())):
        step = par.make_sharded_update_step(mesh, model, resampler, forced)
        state, log_norm = step(bank(seed=7, lw=inp["skew_lw"]), 0, ep_r)
        save(name, locs=state.particle_locations.numpy(),
             lw=state.particle_log_weights.numpy(),
             lw_pre=lw_pre.particle_log_weights.numpy(),
             **scalars(state, log_norm))

    # The smeared resample again under a profiler: the resampler's spans
    # and counters on every rank.
    step = par.make_sharded_update_step(mesh, model, qt.LiuWestResampler(),
                                        forced)
    with profile(activities=[ProfilerActivity.CPU]):
        state, _ = step(bank(seed=7, lw=inp["skew_lw"]), 0, ep_r)
    rec = profiling.recorded()
    spans = rec["spans"]
    save("resample_profiled", locs=state.particle_locations.numpy(),
         tested_rows=np.int64(rec["counters"].get(
             "resamplers.LiuWestResampler.tested_rows", 0)),
         **{f"count_{name}": np.int64(spans[name]["count"] if name in spans
                                      else 0)
            for name in ("qinfer.resamplers.postselect",
                         "qinfer.resamplers.moments",
                         "qinfer.resamplers.valid",
                         "qinfer.sync.postselect")},
         valid_under_postselect=np.int64(
             spans.get("qinfer.resamplers.valid", {"parents": {}})
             ["parents"].get("qinfer.resamplers.postselect", 0)))

    # A two-qubit bank's sharded resample, the smear's draws injected (a
    # rank takes its rows of one global draw a round), through the
    # resampler's loop and through the masked chain it replaced, with the
    # all-reduced check of before.
    basis = tomo.pauli_basis(2)
    tomo_model = qt.BinomialModel(tomo.TomographyModel(basis))
    tomo_locs = tomo.GinibreDistribution(basis, rank=3).sample(
        torch.Generator().manual_seed(3), n)[rows]
    tomo_lw = torch.from_numpy(inp["skew_lw"][rows])
    draw_gen = torch.Generator().manual_seed(4)
    draws = [torch.randn(n, basis.n_elements, generator=draw_gen)[rows]
             for _ in range(17)]
    banks, shapes = {}, []

    def kernel(generator, shape):
        shapes.append(shape)
        return draws[len(shapes) - 1]

    def masked_chain(self, model, generator, centers, S, _all_valid=None,
                     _counts=None):
        return chip_smoke.masked_chain_postselect(
            model, lambda: self._smear(generator, centers, S), self.maxiter,
            lambda ok: int(sharded_smc._psum(torch.sum(~ok), group)) == 0)

    resampler = qt.LiuWestResampler(kernel=kernel)
    postselect = qt.LiuWestResampler._postselect
    for name in ("loop", "masked_chain"):
        shapes.clear()
        if name == "masked_chain":
            qt.LiuWestResampler._postselect = masked_chain
        banks[name] = sharded_smc._sharded_resample(
            tomo_model, resampler, torch.Generator().manual_seed(5),
            tomo_locs, tomo_lw, group, "all_gather").numpy()
        banks[f"{name}_draws"] = np.int64(len(shapes))
        qt.LiuWestResampler._postselect = postselect
    save("resample_tomography_d4", **banks)

    # The same resample through the one-launch round (csrc/psd_valid.cu
    # built by the host's g++, the model's redraw_round pointed at it)
    # and through the masked chain, the last rank's draws zero: its smears
    # are its centers, all states, so it holds no invalid row and walks
    # empty lists while the other ranks redraw.
    lib = _psd_host_kernel.build(out / f"psd_valid_rank{rank}")
    banks = {"built": np.bool_(lib is not None)}
    if lib is not None:
        if rank == world - 1:
            draws = [torch.zeros_like(x) for x in draws]

        def kernel_round(self, device):
            return functools.partial(
                pv._psd_redraw_cuda, basis=self.basis, psd_tol=self.psd_tol,
                allow_subnormalized=self.allow_subnormalized)

        redraw_round = tomo.TomographyModel.redraw_round
        for name in ("kernel", "masked_chain"):
            shapes.clear()
            if name == "kernel":
                tomo.TomographyModel.redraw_round = kernel_round
            else:
                qt.LiuWestResampler._postselect = masked_chain
            with _psd_host_kernel.on_host(lib), profile(
                    activities=[ProfilerActivity.CPU]):
                banks[name] = sharded_smc._sharded_resample(
                    tomo_model, resampler, torch.Generator().manual_seed(5),
                    tomo_locs, tomo_lw, group, "all_gather").numpy()
            tomo.TomographyModel.redraw_round = redraw_round
            qt.LiuWestResampler._postselect = postselect
            counters = profiling.recorded()["counters"]
            banks[f"{name}_draws"] = np.int64(len(shapes))
            for c in ("resamplers.LiuWestResampler.kernel_rounds",
                      "resamplers.LiuWestResampler.tested_rows",
                      "ops.psd_valid.rows"):
                banks[f"{name}_{c.rsplit('.', 1)[1]}"] = np.int64(
                    counters.get(c, 0))
    save("resample_tomography_d4_kernel", **banks)

    # Two spikes at global rows 10 and 100 (weights 0.75, 0.25).
    w = np.full(n, 1e-30)
    w[10], w[100] = 0.75, 0.25
    sample_lw = torch.from_numpy(np.log(w).astype(np.float32)[rows])
    ids = torch.arange(n, dtype=torch.float32)[rows, None]
    gen = torch.Generator().manual_seed(1)
    save("sample", draws=par.sharded_sample(gen, sample_lw, ids, 400,
                                            group).numpy())

    design = {"t": inp["design_t"]}
    binomial = qt.BinomialModel(model)
    for name, m, cand in (
            ("design_precession", model, design),
            ("design_binomial", binomial,
             {"t": inp["design_t"],
              "n_meas": np.full(len(inp["design_t"]), 10, np.int32)})):
        risk, eig = par.make_sharded_expdesign(mesh, m)
        state = bank()
        save(name, risk=risk(state, cand).numpy(),
             eig=eig(state, cand).numpy())

    # The adaptive episodes of config 1 (PGH) and config 5 (greedy EIG).
    pgh = par.make_sharded_pgh_propose(mesh)
    episode = par.make_sharded_adaptive_episode(
        mesh, model, qt.LiuWestResampler(a=0.98),
        qt.SMCConfig(zero_weight_policy="reset"), pgh, [[0.512]],
        int(inp["pgh_steps"]))
    state, rec = episode(bank(seed=11), torch.Generator().manual_seed(12))
    mu, cov = sharded_smc.sharded_moments(
        state.particle_log_weights, state.particle_locations, group)
    save("episode_pgh", mean=mu.numpy(), cov=cov.numpy(),
         n_resamples=state.n_resamples.numpy(),
         finite=np.bool_(torch.isfinite(state.particle_locations).all()),
         **{f"rec_{k}": v.numpy() for k, v in rec.items()
            if k != "expparams"},
         **{f"rec_ep_{k}": v.numpy() for k, v in rec["expparams"].items()})

    tomo_model = tomo.TomographyModel(chip_smoke.PAULI1)
    greedy = par.make_sharded_greedy_propose(
        mesh, tomo_model, {"meas": chip_smoke.EFFECTS_1Q})
    episode = par.make_sharded_adaptive_episode(
        mesh, tomo_model, qt.LiuWestResampler(a=0.98),
        qt.SMCConfig(zero_weight_policy="reset"), greedy,
        chip_smoke.TRUE_X_1Q, int(inp["greedy_steps"]))
    prior_gen = torch.Generator().manual_seed(int(inp["greedy_seed"]))
    full = qt.init_smc_state(prior_gen, tomo_model, n,
                             tomo.GinibreDistribution(chip_smoke.PAULI1))
    state, rec = episode(par.shard_state(full, mesh),
                         torch.Generator().manual_seed(13))
    mu, cov = sharded_smc.sharded_moments(
        state.particle_log_weights, state.particle_locations, group)
    valid = torch.all(tomo_model.are_models_valid(mu[None]))
    save("episode_greedy", mean=mu.numpy(), cov=cov.numpy(),
         valid=valid.numpy(), n_resamples=state.n_resamples.numpy(),
         **{f"rec_{k}": v.numpy() for k, v in rec.items()
            if k != "expparams"},
         **{f"rec_ep_{k}": v.numpy() for k, v in rec["expparams"].items()})

    # A learned-σ walk that never resamples (the time step's draws).
    walk = qt.GaussianRandomWalkModel(model, diagonal=True)
    step = par.make_sharded_update_step(
        mesh, walk, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0))
    state = shard_from_numpy(state_arrays(inp["walk_locs"], inp["lw"]), mesh,
                             seed=3)
    for t, outcome in zip(inp["walk_t"], inp["walk_outcomes"]):
        state, log_norm = step(state, int(outcome),
                               {"t": np.array([t], np.float32)})
    save("walk", locs=state.particle_locations.numpy(),
         lw=state.particle_log_weights.numpy(), **scalars(state, log_norm))

    # DirectViewParallelizedModel above, below and off its threshold.
    counted = CountingPrecession()
    wrapped = par.DirectViewParallelizedModel(underlying_model=counted,
                                              mesh=mesh, serial_threshold=100)
    outcomes = torch.tensor([0, 1])
    like = {}
    for m in (n, 64, n - 2):
        ROWS_SEEN.clear()
        like[f"n{m}"] = wrapped.likelihood(
            outcomes, torch.from_numpy(inp["locs"][:m]), ep).numpy()
        like[f"rows{m}"] = np.asarray(ROWS_SEEN)
    st, log_norm = qt.smc_update_step(
        wrapped, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0),
        state_from_numpy(state_arrays(inp["locs"], inp["lw"])), 1,
        {"t": torch.tensor([5.0])})
    save("direct_view", **like, step_lw=st.particle_log_weights.numpy(),
         step_log_norm=log_norm.numpy())

    # The 2-D mesh's blocks, replicate, and a bank that does not split.
    mesh2 = par.host_local_mesh(2, device_type="cpu")
    uneven = state_from_numpy(state_arrays(inp["locs"][:n - 1],
                                           inp["lw"][:n - 1]))
    try:
        par.shard_state(uneven, mesh)
        refused = False
    except ValueError:
        refused = True
    save("mesh", uneven_refused=np.bool_(refused),
         trial_seeds=par.shard_episode_keys(np.arange(8), mesh2),
         particle_rank=np.int64(mesh2.get_local_rank(par.PARTICLE_AXIS)),
         replicated=par.replicate(
             {"x": torch.full((3,), float(rank))}, mesh)["x"].numpy())


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
