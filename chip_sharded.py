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
   checked as ``__graft_entry__.dryrun_multichip`` checks it.

It prints the card line, then one JSON line a rank with every phase, and
exits 0 only when every rank passed every phase. It needs two cards or
more (``chip_smoke.py`` runs the sharded paths on one). Imports nothing
of JAX.
"""

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
from qinfer_tpu_torch.entry import dryrun_multichip

WALL_S = 900  # the ranks' whole run
GROUP_TIMEOUT_S = 300  # each collective


def phase_pick(group, rank, n_local, device):
    """All-gather and ring picks of this rank's window against one bank."""
    n = n_local * dist.get_world_size(group)
    rng = np.random.default_rng(7)
    log_w = torch.as_tensor(cs._weights("random", n, rng), device=device)
    ids = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    rows = slice(rank * n_local, (rank + 1) * n_local)
    one = cs.b2.systematic_expand(log_w, ids, u0=0.37)[rows]
    gathered = cs.par.distributed_systematic_pick(
        None, log_w[rows], ids[rows], group, u0=0.37)
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


def rank_main(args):
    cpu = args.cpu > 0
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", args.rank))
    if not cpu:
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.N_FLAGSHIP = args.n
    dist.init_process_group(
        "gloo" if cpu else "nccl",
        init_method=f"file://{os.path.join(args.dir, 'store')}",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
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
                  "dryrun": phase_dryrun(mesh)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(result, f)


def main(args):
    world = args.cpu if args.cpu > 0 else torch.cuda.device_count()
    if world < 2:
        print(f"chip_sharded: needs two ranks or more, has {world}",
              file=sys.stderr)
        return 1
    if args.cpu == 0:
        cs.phase_device()
        cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--dir", tmp, "--n", str(args.n),
             "--cpu", str(args.cpu)],
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + WALL_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            late = [p for p in procs if p.poll() is None]
            for p in late:
                p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        ok = not late and all(p.returncode == 0 for p in procs)
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if not os.path.exists(path):
                with open(os.path.join(tmp, f"log{r}.txt")) as f:
                    print(f"rank {r} wrote no result:\n{f.read()[-3000:]}",
                          file=sys.stderr)
                ok = False
                continue
            with open(path) as f:
                result = json.load(f)
            print(json.dumps(result))
            ok &= all(result[phase]["ok"] for phase in (
                "pick", "update", "sharded_flagship",
                "sharded_flagship_ring", "dryrun"))
    if late:
        print(f"chip_sharded: {len(late)} ranks still ran after {WALL_S} s",
              file=sys.stderr)
    print(json.dumps({"ok": bool(ok), "world_size": world}))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="run this many gloo ranks on the CPU")
    ap.add_argument("--n", type=int, default=cs.N_FLAGSHIP,
                    help="particles in the whole bank")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        sys.exit(0)
    sys.exit(main(args))
