#!/usr/bin/env python3
"""The sharded layer across the NVIDIA GPUs of one host: one rank a card.

    python3 chip_sharded.py                 # a rank on every visible card
    python3 chip_sharded.py --cpu 4 --n 16384   # four gloo ranks, CPU

Builds the kernels once, then starts one process a rank, joined through a
file store in a temporary directory (NCCL on the cards, gloo with
``--cpu``); every collective has a group timeout and the whole run a wall
clock that kills the ranks. Each rank, on its own card, over a bank of N
particles (2^20 by default) made from a seed:

1. pick: the all-gather route's rows of the rank's window bit-equal to
   one bank's ``systematic_expand`` of the whole bank (computed on every
   rank), both through kernel B2 on the cards; the ring's rows against
   them (the rows that differ are counted; the picks carry particle ids);
2. update: one sharded update against the one-bank step of the same bank
   (B1 with ``return_stats`` on each rank against B1 on one bank on the
   cards): log-weights, evidence and ESS within ``chip_smoke.B1_TOL``;
3. ``sharded_flagship`` (``chip_smoke.sharded_flagship_window``) with the
   all-gather migration (a warm-up and three gated windows) and the ring
   (one window): B1 once an update; B2 at least once a resample on the
   all-gather, never on the ring;
4. dryrun: ``qinfer_tpu_torch.entry.dryrun_multichip`` on the rank's
   particle mesh, every sharded path on tiny shapes (the step, both
   migrations, sharded design, the adaptive episodes with both proposes,
   a time-dependent model, the trials axis of ``host_local_mesh``), each
   checked as ``__graft_entry__.dryrun_multichip`` checks it;
5. config5_sharded: ``examples_torch`` config 5's ``main_sharded`` (512
   particles a rank, 160 EIG-designed steps through
   ``make_sharded_adaptive_episode`` and ``make_sharded_greedy_propose``),
   gated by the example's own assert.

Then, after that world has ended, the scaling phase
(``bench_torch.scaling``, ``bench_scaling.py``'s twin): a fresh world of
k ranks for k = 1, 2, 4 … up to the cards, one after another, each
printing the collective inventory of one resampling step per migration
(``collective_bytes_per_step``) and the particle-updates/s at 2^15 and
2^18 particles a rank (``--per-shard``) with the weak-scaling efficiency
(``sharded_particle_updates_per_s@{k}dev``).

Every world starts through ``qinfer_tpu_torch.parallel.launch``. The
script prints the card line, one JSON line a rank with every phase, the
scaling rows, and exits 0 only when every rank passed every phase and
every scaling world ran. It needs two cards or more (``chip_smoke.py``
runs the sharded paths on one). Imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch
import torch.distributed as dist

import bench_torch
import chip_smoke as cs
from examples_torch.config5_adaptive_tomography import (
    main_sharded as config5_sharded,
)
from qinfer_tpu_torch.entry import dryrun_multichip
from qinfer_tpu_torch.parallel import launch

WALL_S = launch.WALL_S  # each world's whole run
GROUP_TIMEOUT_S = launch.GROUP_TIMEOUT_S  # each collective


def phase_pick(group, rank, n_local, device):
    """All-gather and ring picks of this rank's window against one bank."""
    n = n_local * dist.get_world_size(group)
    rng = np.random.default_rng(7)
    log_w = torch.as_tensor(cs._weights("random", n, rng), device=device)
    ids = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    rows = slice(rank * n_local, (rank + 1) * n_local)
    one = cs.b2.systematic_expand(log_w, ids, u0=0.37)[rows]
    gathered = cs.par.distributed_systematic_pick(
        None, log_w[rows], ids[rows], group, use_expand_kernel=True, u0=0.37)
    ring = cs.par.distributed_systematic_pick_ring(
        None, log_w[rows], ids[rows], group, u0=0.37)
    ring_rows = int(torch.count_nonzero(ring != gathered))
    return {"ok": bool(torch.equal(gathered, one)),
            "ring_rows_differing": ring_rows}


def phase_update(mesh, rank, n, device):
    """One sharded update of a bank against the one-bank step."""
    model = cs.qt.SimplePrecessionModel()
    config = cs.qt.SMCConfig(resample_thresh=-1.0, zero_weight_policy="reset")
    g = torch.Generator(device=device).manual_seed(3)
    bank = cs.qt.init_smc_state(g, model, n, cs.qt.UniformDistribution([0, 1]))
    ep = {"t": torch.tensor([5.0], device=device)}
    step = cs.par.make_sharded_update_step(mesh, model,
                                           cs.qt.LiuWestResampler(), config)
    shard, log_norm = step(cs.par.shard_state(bank, mesh), 1, ep)
    one, log_norm_1 = cs.qt.smc_update_step(
        model, cs.qt.LiuWestResampler(), config, bank, 1, ep)
    n_local = shard.particle_log_weights.shape[0]
    rows = slice(rank * n_local, (rank + 1) * n_local)
    lw_err = float(torch.max(torch.abs(
        shard.particle_log_weights - one.particle_log_weights[rows])))
    ln_err = abs(float(log_norm) - float(log_norm_1))
    ess_rel = abs(float(shard.min_n_ess) / float(one.min_n_ess) - 1.0)
    tol = cs.B1_TOL
    return {"ok": (lw_err <= tol["lw_atol"] and ln_err <= tol["log_norm_atol"]
                   and ess_rel <= tol["ess_rtol"]),
            "lw_err": lw_err, "log_norm_err": ln_err, "ess_rel": ess_rel}


def phase_flagship(mesh, migration, n_windows, device):
    """A warm-up window, then ``n_windows`` gated windows of the flagship
    record, the kernels' launches counted over them."""
    ring = migration == "ring"
    cs.sharded_flagship_window(mesh, migration, 10_000, 0, device)
    cs._reset_counters()
    windows = [cs.sharded_flagship_window(mesh, migration, 1000 * (i + 1),
                                          i, device)
               for i in range(n_windows)]
    counts, rounds = cs._read_counters()
    ms = [1e3 * w["seconds"] for w in windows]
    resamples = sum(w["resamples"] for w in windows)
    if device.type == "cuda":  # the kernels launch on the cards only
        b1_ok = counts["B1"] == cs.N_EXP * n_windows
        b2_ok = counts["B2"] == 0 if ring else counts["B2"] >= resamples > 0
    else:
        b1_ok = b2_ok = counts["B1"] == counts["B2"] == 0
    return {"ok": all(w["ok"] for w in windows) and b1_ok and b2_ok,
            "window_ms_median": statistics.median(ms), "window_ms": ms,
            "resamples": [w["resamples"] for w in windows],
            "redraw_rounds": rounds, "launches": counts,
            "est": [w["est"] for w in windows]}


def phase_dryrun(mesh):
    """``dryrun_multichip`` on ``mesh``: it raises on a failed check, so
    a rank that returns passed every one."""
    return {"ok": True, **dryrun_multichip(mesh)}


def phase_config5_sharded(device):
    """``examples_torch`` config 5's ``main_sharded`` on this rank (512
    particles a rank, 160 steps): it asserts the example's own gate."""
    state, err0, err = config5_sharded(seed=0, device=device)
    return {"ok": True, "err0": err0, "err": err,
            "resamples": int(state.n_resamples)}


PHASES = ("pick", "update", "sharded_flagship", "sharded_flagship_ring",
          "dryrun", "config5_sharded")


def rank_main(args):
    cpu = args.cpu > 0
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", args.rank))
    if not cpu:
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.N_FLAGSHIP = args.n
    with launch.process_group(args.dir, args.rank, args.world,
                              "gloo" if cpu else "nccl",
                              timeout_s=GROUP_TIMEOUT_S):
        mesh = cs.par.make_particle_mesh(device_type=device.type)
        group = mesh.get_group(cs.par.PARTICLE_AXIS)
        n_local = args.n // args.world
        result = {"rank": args.rank, "world_size": args.world,
                  "n_particles": args.n, "device": str(device),
                  "pick": phase_pick(group, args.rank, n_local, device),
                  "update": phase_update(mesh, args.rank, args.n, device),
                  "sharded_flagship": phase_flagship(mesh, "all_gather", 3,
                                                     device),
                  "sharded_flagship_ring": phase_flagship(mesh, "ring", 1,
                                                          device),
                  "dryrun": phase_dryrun(mesh),
                  "config5_sharded": phase_config5_sharded(device)}
    launch.write_result(args.dir, args.rank, result)


def phase_scaling(world, cpu, per_shards):
    """bench_torch.py's scaling rows (``bench_scaling.py``'s) at k = 1, 2,
    4 … up to ``world`` ranks, a fresh world each, one after another:
    the collective inventory of a resampling step per migration and the
    particle-updates/s with the weak-scaling efficiency at each of
    ``per_shards`` particles a rank. Prints each row; True when every
    world ran and every row is finite."""
    ks = [k for k in bench_torch.SCALING_KS if k <= world]
    rows = bench_torch.scaling(ks, per_shards, cpu=cpu, wall_s=WALL_S)
    card = bench_torch.cpu_info() if cpu else bench_torch.device_info()
    for row in rows:
        row["device"] = card
        print(json.dumps(row))
    pps = [r for r in rows if r["metric"] != "collective_bytes_per_step"]
    return (len(pps) == len(ks) * len(per_shards)
            and all(np.isfinite(r["value"]) and r["weak_scaling_efficiency"]
                    is not None for r in pps))


def main(args):
    world = args.cpu if args.cpu > 0 else torch.cuda.device_count()
    if world < 2:
        print(f"chip_sharded: needs two ranks or more, has {world}",
              file=sys.stderr)
        return 1
    if args.cpu == 0:
        cs.phase_device()
        cs.phase_build()
    run = launch.run_ranks(
        [os.path.abspath(__file__), "--n", str(args.n), "--cpu",
         str(args.cpu)], world, WALL_S)
    ok = run.ok
    for result in run.results:
        if result is not None:
            print(json.dumps(result))
            ok &= all(result[phase]["ok"] for phase in PHASES)
    if not run.ok:
        print(run.failure(), file=sys.stderr)
    ok &= phase_scaling(world, args.cpu, args.per_shard)
    print(json.dumps({"ok": bool(ok), "world_size": world}))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="run this many gloo ranks on the CPU")
    ap.add_argument("--n", type=int, default=cs.N_FLAGSHIP,
                    help="particles in the whole bank")
    ap.add_argument("--per-shard", type=int, nargs="+",
                    default=bench_torch.PER_SHARDS,
                    help="scaling: particles a rank, one set each")
    launch.add_rank_arguments(ap)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        sys.exit(0)
    sys.exit(main(args))
