#!/usr/bin/env python3
"""Where the time of each chip_smoke.py path goes, on one NVIDIA GPU.

    python3 chip_profile.py [--paths [NAME ...]] [--parent DIR ...]
        [--b1-forms] [--b1-paths] [--b2-forms] [--kernel-split]

For each path (the flagship, configs 2–4, config 5, two-qubit tomography,
the PGH loops of config 1 and config 4's known-T2, the three model-zoo
paths (``chip_smoke.ZOO_PATHS``) and the user model's four
(``chip_smoke.USER_PATHS``), all at 2^20 particles, the three trial
ensembles (the user model's too), and the four sharded paths (``SHARDED_NAMES``, on an
NCCL process group of one rank, after one line of the host µs per
collective and per scalar read there), as ``chip_smoke.py`` runs them;
``--paths`` picks some, and ``--paths`` with no name none) it prints one
JSON line with:

- ``window_ms``: unprofiled windows, after one warm-up window;
- ``no_resample_ms``: windows with ``resample_thresh=-1`` (no resampling);
- ``no_postselect_ms``: windows with ``LiuWestResampler(postselect=False)``,
  and their resample counts (for an ensemble a window is one timed
  ``perf_test_multiple`` run and its resamples are summed over trials);
- ``redraw_rounds_per_resample`` of the unprofiled windows;
- one window under ``torch.profiler``: the device's busy time (the union
  of its kernel intervals), the idle share against the median unprofiled
  window, the number of device events, of scalar reads to the host
  (``aten::_local_scalar_dense``) and of collectives by name (``nccl:*``,
  ``c10d::*``), the eight largest device items and the eight host ops
  with the most host time of their own.

``--parent DIR ...`` also times B1's tiles (``chip_smoke.phase_timing_zoo``),
B1's flagship tile and B2 at D = 1, 4, 16 (``chip_smoke.phase_timing``)
and both batched kernels in both ensemble regimes
(``chip_smoke.phase_timing_batched``) in each tree DIR and in this one, in
the order DIR…, this, this, …DIR, twice, each in a fresh process that
builds its kernels, and prints each tree's ptxas register lines, then per
tile and tree the µs of every process and their mean. ``--b2-forms``
times B2's forms against each other at each width and on the small
launches of the ensembles and of the examples' own banks, the bank form
at several blocks a trial (``compare_b2_forms``),
``--b1-paths`` B1's two column paths at each row stride
(``compare_b1_paths``), ``--b1-forms`` the per-column path's one-launch
and two-pass forms (``compare_b1_forms``); ``--kernel-split`` gives the
device µs of each kernel that a tile's call launches (``kernel_split``).
Imports nothing of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

N = cs.N_FLAGSHIP
SEEDS = (0, 1, 2)


def _updater(model, prior, seed, device, **kw):
    return cs.qt.SMCUpdater(model, N, prior, zero_weight_policy="reset",
                            seed=seed, device=device, **kw)


def flagship(seed, device, **kw):
    ts, outcomes = cs.experiment_record(cs.N_EXP, 0)
    u = _updater(cs.qt.SimplePrecessionModel(),
                 cs.qt.UniformDistribution([0, 1]), seed, device, **kw)
    return _batch(u, outcomes, {"t": ts})


def _batch(u, outcomes, expparams):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u.batch_update(outcomes, expparams)
    u.est_mean().cpu()  # forces the window to finish
    return time.perf_counter() - t0, u.resample_count


def config_runner(make):
    cfg = make()

    def run(seed, device, **kw):
        u = _updater(cfg.model, cs.qt.UniformDistribution(cfg.prior), seed,
                     device, **kw)
        return _batch(u, cfg.outcomes, cfg.expparams)
    return run


def config5(seed, device, **kw):
    u = _updater(cs.tomo.TomographyModel(cs.PAULI1),
                 cs.tomo.GinibreDistribution(cs.PAULI1), seed, device, **kw)
    w = cs.config5_window(u, seed)
    return w["seconds"], u.resample_count


def tomography_2q(seed, device, **kw):
    u = _updater(cs.qt.BinomialModel(cs.tomo.TomographyModel(cs.PAULI2)),
                 cs.tomo.GinibreDistribution(cs.PAULI2), seed, device, **kw)
    w = cs.tomography_2q_window(u)
    return w["seconds"], u.resample_count


def pgh_runner(model, truth):
    def run(seed, device, **kw):
        w = cs.pgh_window(model, truth, seed, device, **kw)
        return w["seconds"], w["resamples"]
    return run


def ensemble_runner(n_trials, n, n_exp, **model):
    def run(seed, device, resample_thresh=None, resampler=None):
        extra = ({} if resample_thresh is None
                 else {"resample_thresh": resample_thresh})
        seconds, perf, _ = cs.ensemble_run(
            n_trials, n, n_exp, seed, device, extra_updater_args=extra,
            resampler=resampler, **model)
        return seconds, int(perf["resample_count"][:, -1].sum())
    return run


def user_runner(model, record, n_meas):
    def run(seed, device, **kw):
        outcomes, ep = cs.user_record(record, n_meas)
        u = _updater(model, cs.qt.UniformDistribution(cs.USER_PRIOR), seed,
                     device, **kw)
        return _batch(u, outcomes, ep)
    return run


def zoo_runner(make, window):
    def run(seed, device, **kw):
        w = window(make(N, seed, device, **kw))
        return w["seconds"], w["resamples"]
    return run


PATHS = {"flagship": flagship,
         **{make.__name__: config_runner(make) for make in cs.CONFIGS},
         "config5_adaptive_tomography": config5,
         "tomography_2q_binomial": tomography_2q,
         **{name: pgh_runner(model, truth)
            for name, model, truth, _ in cs.PGH_PATHS},
         **{name: ensemble_runner(t, n, e) for name, t, n, e in cs.ENSEMBLES},
         **{name: zoo_runner(make, window)
            for name, make, window, _ in cs.ZOO_PATHS},
         **{name: user_runner(model, record, n_meas)
            for name, model, record, n_meas in cs.USER_PATHS},
         cs.USER_ENSEMBLE[0]: ensemble_runner(
             *cs.USER_ENSEMBLE[1:], model=cs.LostVisibilityModel(),
             prior=cs.qt.UniformDistribution(cs.USER_PRIOR))}


# The sharded paths of chip_smoke.phase_sharded; main() runs them on an
# NCCL process group of one rank (chip_smoke.nccl_world_one).
SHARDED_NAMES = ("sharded_flagship", "sharded_flagship_ring",
                 "sharded_config1_pgh", "sharded_config5_eig")


def sharded_paths(mesh):
    """The runners of ``SHARDED_NAMES`` on ``mesh``."""
    def runner(kind, migration="all_gather"):
        def run(seed, device, resample_thresh=None, resampler=None):
            config = (None if resample_thresh is None else cs.qt.SMCConfig(
                zero_weight_policy="reset", resample_thresh=resample_thresh))
            kw = dict(config=config, resampler=resampler)
            if kind == "flagship":
                w = cs.sharded_flagship_window(mesh, migration, seed, 0,
                                               device, **kw)
            else:
                w = cs.sharded_episode_window(mesh, kind, seed, device, **kw)
            return w["seconds"], w["resamples"]
        return run

    return dict(zip(SHARDED_NAMES, (runner("flagship"),
                                    runner("flagship", "ring"),
                                    runner("pgh"), runner("eig"))))


def collective_cost(device, iters=1000):
    """Host µs per call on the one-rank NCCL group: ``all_reduce`` of a
    0-d tensor, ``all_gather`` of a 1-element one into a list, and a
    scalar read to the host (``float``), each ``iters`` calls in a row,
    the device synchronised before and after."""
    dist = cs.dist
    x = torch.zeros((), device=device)
    parts = [torch.zeros(1, device=device)]

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / iters

    print(json.dumps({"collective_host_us": {
        "all_reduce": per_call(lambda: dist.all_reduce(x)),
        "all_gather": per_call(lambda: dist.all_gather(parts, x[None])),
        "scalar_read": per_call(lambda: float(x + 1.0))}}), flush=True)


def device_busy(prof):
    """Busy ms (union of device intervals), events, scalar reads, the
    collectives by name, the top device items and the top host ops by
    their own host time."""
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    averages = prof.key_averages()
    top = sorted(averages, key=lambda k: -k.device_time_total)[:8]
    host = sorted(averages, key=lambda k: -k.self_cpu_time_total)[:8]
    collectives = {}
    for e in events:
        if e.name.startswith(("nccl:", "c10d::")):
            collectives[e.name] = collectives.get(e.name, 0) + 1
    return {"busy_ms": busy / 1e3, "device_events": len(spans),
            "scalar_reads": sum(e.name == "aten::_local_scalar_dense"
                                for e in events),
            "collectives": collectives,
            "top": [(k.key[:60], k.device_time_total / 1e3, k.count)
                    for k in top],
            "host_top": [(k.key[:60], k.self_cpu_time_total / 1e3, k.count)
                         for k in host]}


def profile_path(name, run, device):
    run(10_000, device)  # warm-up
    cs.qt.LiuWestResampler.redraw_rounds = 0
    windows = [run(s, device) for s in SEEDS]
    rounds = cs.qt.LiuWestResampler.redraw_rounds
    no_rs = [run(s, device, resample_thresh=-1.0)[0] for s in SEEDS]
    no_ps = [run(s, device, resampler=cs.qt.LiuWestResampler(
        a=0.98, postselect=False)) for s in SEEDS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run(SEEDS[0], device)
    median = statistics.median(w[0] for w in windows)
    rec = {"path": name,
           "window_ms": [1e3 * w[0] for w in windows],
           "resamples": [w[1] for w in windows],
           "redraw_rounds_per_resample":
               rounds / max(1, sum(w[1] for w in windows)),
           "no_resample_ms": [1e3 * s for s in no_rs],
           "no_postselect_ms": [1e3 * w[0] for w in no_ps],
           "no_postselect_resamples": [w[1] for w in no_ps],
           "profiled_window_ms": 1e3 * profiled[0]}
    rec.update(device_busy(prof))
    rec["idle_vs_median"] = 1.0 - rec["busy_ms"] / (1e3 * median)
    print(json.dumps(rec), flush=True)


# Both trees' timing phases (a chip_smoke.py with phase_timing_batched): B1's
# flagship tile, B2 at D = 1, 4, 16, every B1 tile, and both batched
# kernels in both ensemble regimes (batched B2 on synthetic inputs of every
# trial, chip_smoke.batched_b2_inputs).
TIMING = ("import json, torch, chip_smoke as cs; cs.phase_build(); "
          "torch.backends.cuda.matmul.allow_tf32 = False; "
          "d = torch.device('cuda', 0); "
          "b = {f'{t}x{n}': (lambda s, v, m: (s, v, 0.98, 0.02 * m))("
          "*cs.batched_b2_inputs(t, n, 1, 7, d)) "
          "for t, n, _ in cs.B2_BATCH_SHAPES[:2]}; "
          "t = {**cs.phase_timing(d), **cs.phase_timing_zoo(d), "
          "**cs.phase_timing_batched(d, b)}; "
          "t = {k: v['ms'] for k, v in t.items()}; "
          "print('TILE_MS', json.dumps(t))")


def compare_tiles(parents, rounds=2):
    """B1 tile and B2 µs at 2^20 in each tree of ``parents`` and in this
    one ("this"), alternated: parents, this, this, parents reversed, per
    round."""
    trees = [(p, p) for p in parents] + [("this", ".")]
    order = (trees + trees[::-1]) * rounds
    out, regs = {}, {}
    for label, tree in order:
        res = subprocess.run([sys.executable, "-c", TIMING], cwd=tree,
                             capture_output=True, text=True, timeout=900,
                             check=True)
        lines = res.stdout.splitlines()
        regs[label] = [ln.strip() for ln in lines
                       if "ptxas" in ln and "registers" in ln]
        times = json.loads(next(ln for ln in lines
                                if ln.startswith("TILE_MS"))[8:])
        for tile, k in times.items():
            out.setdefault(tile, {}).setdefault(label, []).append(1e3 * k)
    for label, lines in regs.items():
        print(f"ptxas {label}:", json.dumps(lines))
    print(json.dumps({"tile_us_at_2^20": {
        tile: {label: {"mean": float(np.mean(v)), "runs": v}
               for label, v in by.items()}
        for tile, by in out.items()}}))


def kernel_split(device, iters=20):
    """Device µs of each kernel that one call of a B1 tile or of B2 at
    2^20 launches (``torch.profiler``, mean over ``iters`` calls), beside
    the call's µs from CUDA events (``chip_smoke._time_ms``); the
    difference is the device's idle time between the kernels."""
    cases = [(name, cs.zoo_inputs(case, N, 7, device))
             for case in cs.ZOO for name in [case[0]]]
    cases += [(case[0], cs.tomo_inputs(case, N, 7, device))
              for case in cs.TOMO]
    calls = {name: (lambda t=t: cs.b1.fused_bayes_update(*t))
             for name, t in cases}
    tile, scal, lw, cols = cases[0][1]  # ZOO's first tile, in two passes
    calls[f"{cases[0][0]}[two passes]"] = lambda: cs.b1._fused_update_cuda(
        tile, scal[None], lw[None], tuple(c[None] for c in cols),
        form=cs.b1.TWO_PASS, normalize=True)
    rng = np.random.default_rng(1)
    log_w = torch.as_tensor(cs._weights("random", N, rng), device=device)
    starts = cs.systematic_segment_starts(log_w, N, u0=0.37)
    for d in (1, 4, 16):
        vals = torch.rand((N, d), device=device)
        aff = cs.b2._affine(0.98, 0.02 * vals.mean(0), d, device)
        calls[f"B2[D={d}]"] = (lambda v=vals, a=aff:
                               cs.b2._expand_cuda(starts, v, N, a))
    out = {}
    for name, fn in calls.items():
        event_us = 1e3 * cs._time_ms(fn, iters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = {k.key[:48]: k.device_time_total / k.count
                   for k in prof.key_averages() if k.device_time_total > 0}
        out[name] = {"event_us": event_us, "kernels_us": kernels}
    print(json.dumps({"kernel_split": out}))


B1_PATH_STRIDES = (2, 3, 4, 5, 8, 12, 16, 17)


def compare_b1_paths(device, rounds=2):
    """B1's two column paths, forced, on the same views of a 2^20 × s bank
    (a binomial Born tile over min(s, 16) columns, ``chip_smoke.
    span_inputs``) at each row stride of B1_PATH_STRIDES, in turns row
    span, per column, per column, row span; µs of each timing and their
    mean, per stride and path."""
    out = {}
    for s in B1_PATH_STRIDES:
        tile, scal, lw, cols = cs.span_inputs(s, min(s, 16), "rows", N, 7,
                                              device)
        args = (tile, scal[None], lw[None], tuple(c[None] for c in cols))
        runs = {True: [], False: []}
        for _ in range(rounds):
            for path in (True, False, False, True):
                runs[path].append(1e3 * cs._time_ms(
                    lambda: cs.b1._fused_update_cuda(*args, row_span=path),
                    20))
        out[f"s={s}"] = {label: {"mean": float(np.mean(runs[path])),
                                 "runs": runs[path]}
                         for label, path in (("row_span", True),
                                             ("per_column", False))}
    print(json.dumps({"b1_path_us": out}))


ALL_RESIDENT = "one_launch_all_resident"


def compare_b1_forms(device, rounds=2):
    """B1's per-column forms, one launch (its grid at most half the
    resident blocks, and ALL_RESIDENT: up to every resident block) and two
    passes (with the wrapper's lw − lse), forced on the same inputs: the
    flagship tile, each ZOO tile and the qubit Born tiles at 2^20, and the
    ensembles' precession tile at both ensemble shapes, in turns one, two,
    all, all, two, one; µs of each timing and their mean, per case and
    form."""
    b1 = cs.b1
    tile = b1.two_outcome_tile(b1.precession_pr1)
    omega, lw = cs._b1_inputs(N, 7, device)
    cases = {"precession": (tile, torch.tensor([[1.0, 17.3]], device=device),
                            lw[None], (omega[None],))}
    singles = [(case[0], cs.zoo_inputs(case, N, 7, device)) for case in cs.ZOO]
    singles += [(case[0], cs.tomo_inputs(case, N, 7, device))
                for case in cs.TOMO[:2]]
    for name, (t, scal, w, cols) in singles:
        cases[name] = (t, scal[None], w[None], tuple(c[None] for c in cols))
    for n_trials, n in cs.B1_BATCH_SHAPES[:2]:
        cases[f"precession {n_trials}x{n}"] = cs.batched_b1_inputs(
            "precession", n_trials, n, 7, device)
    capacity = b1._capacity
    forms = (b1.ONE_LAUNCH, b1.TWO_PASS, ALL_RESIDENT)
    out = {}
    for name, args in cases.items():
        runs = {form: [] for form in forms}
        for _ in range(rounds):
            for form in forms + forms[::-1]:
                # ALL_RESIDENT: the one-launch form's grid planned for twice
                # the card's capacity, i.e. up to every resident block.
                b1._capacity = (capacity if form != ALL_RESIDENT else
                                lambda *key: 2 * capacity(*key))
                runs[form].append(1e3 * cs._time_ms(
                    lambda: b1._fused_update_cuda(
                        *args, row_span=False, normalize=True,
                        form=b1.ONE_LAUNCH if form == ALL_RESIDENT else form),
                    20))
                b1._capacity = capacity
        out[name] = {form: {"mean": float(np.mean(v)), "runs": v}
                     for form, v in runs.items()}
        out[name]["plan"] = cs.b1_plan(args[0], args[2], args[3])
    print(json.dumps({"b1_form_us": out}))


B2_FORM_WIDTHS = (1, 2, 3, 4, 5, 8, 12, 16, 17)
# (T, N) of the small launches, timed at each of B2_SMALL_WIDTHS: the
# ensembles' resamples (chip_smoke.py's B2Capture: 74 of ensemble_small's
# 256 trials of 2048 at the median, up to all 256; ensemble_big's 1 and 4
# of 2^18), and single banks at the examples' own N (the random walk and
# the die 2000, config 5 4000, configs 1 and 4 PGH 5000, two-qubit
# tomography 10000), at 16385 and at 2^17.
B2_SMALL_LAUNCHES = ((74, 2048), (128, 2048), (256, 2048), (512, 2048),
                     (1024, 2048), (4, 2048), (16, 2048), (1, 2000),
                     (1, 4000), (1, 5000), (1, 10000), (1, 16385),
                     (1, 1 << 17), (1, 1 << 18), (4, 1 << 18))
B2_SMALL_WIDTHS = (1, 2, 3, 4, 8)
# Rows a tile of the bank form, timed beside the wrapper's tiling where the
# bank allows: searched tiles of 256 and 512, scanned tiles of 2048.
BANK_TILE_ROWS = (256, 512, 2048)


def compare_b2_forms(device, rounds=2):
    """B2's forms at 2^20 rows and each width of B2_FORM_WIDTHS (one thread
    per row, a warp per span of rows, and up to D = 8 the merge path), and
    on each of B2_SMALL_LAUNCHES at each of B2_SMALL_WIDTHS (rows, merge,
    and the bank form at the wrapper's tiling and at tiles of each of
    BANK_TILE_ROWS rows, where a bank's starts fit a block), in turns
    forward then back; µs of each timing and their mean,
    per case and form. The first line is the floor of one queued launch
    (``chip_smoke.launch_floor_ms``)."""
    b2 = cs.b2
    print(json.dumps({"launch_floor_us": 1e3 * cs.launch_floor_ms()}))
    rng = np.random.default_rng(1)
    log_w = torch.as_tensor(cs._weights("random", N, rng), device=device)
    starts = cs.systematic_segment_starts(log_w, N, u0=0.37)[None]
    cases = {}
    for d in B2_FORM_WIDTHS:
        vals = torch.rand((1, N, d), device=device)
        forms = ((b2.ROWS, None), (b2.SPAN, None)) + (
            ((b2.MERGE, None),) if d <= 8 else ())
        cases[f"D={d}"] = (starts, vals, N, b2._affine_batched(
            0.98, 0.02 * vals[0].mean(0), 1, d, device), forms)
    for n_trials, n in B2_SMALL_LAUNCHES:
        for d in B2_SMALL_WIDTHS:
            s, v, mu = cs.batched_b2_inputs(n_trials, n, d, 7, device)
            tilings = {b2.bank_tiles(n_trials, n)} | {
                -(-n // rows) for rows in BANK_TILE_ROWS}
            forms = ((b2.ROWS, None), (b2.MERGE, None)) + tuple(
                (b2.BANK, t) for t in sorted(tilings) if n <= b2.BANK_CAP)
            cases[f"{n_trials}x{n} D={d}"] = (s, v, n, b2._affine_batched(
                0.98, 0.02 * mu, n_trials, d, device), forms)
    out = {}
    for name, (s, v, n, aff, forms) in cases.items():
        runs = {form: [] for form in forms}
        for _ in range(rounds):
            for form, tiles in forms + forms[::-1]:
                runs[form, tiles].append(1e3 * cs._time_ms(
                    lambda: b2._expand_cuda_batched(s, v, n, aff, form=form,
                                                    tiles=tiles), 20))
        out[name] = {_form_label(*form): {"mean": float(np.mean(r)),
                                          "runs": r}
                     for form, r in runs.items()}
        out[name]["wrapper"] = _form_label(
            b2.kernel_form(v.shape[2], v.shape[0], v.shape[1], n),
            b2.bank_tiles(v.shape[0], n))
    print(json.dumps({"b2_form_us": out}))


def _form_label(form, tiles):
    """The form's name; the bank form's with its blocks a trial."""
    name = cs.b2.FORM_NAMES[form]
    return f"{name}/{tiles}" if form == cs.b2.BANK and tiles else name


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="+", default=[],
                    help="trees to time the kernels against")
    ap.add_argument("--paths", nargs="*",
                    choices=sorted(PATHS) + list(SHARDED_NAMES),
                    help="profile only these paths (default: all)")
    ap.add_argument("--b2-forms", action="store_true",
                    help="time B2's forms at each width and small launch")
    ap.add_argument("--b1-paths", action="store_true",
                    help="time B1's two column paths at each row stride")
    ap.add_argument("--b1-forms", action="store_true",
                    help="time B1's one-launch and two-pass forms")
    ap.add_argument("--kernel-split", action="store_true",
                    help="device µs of each kernel of each tile's call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    for name, run in PATHS.items():
        if args.paths is None or name in args.paths:
            profile_path(name, run, device)
    sharded = [n for n in SHARDED_NAMES
               if args.paths is None or n in args.paths]
    if sharded:
        with cs.nccl_world_one(device) as mesh:
            collective_cost(device)
            runners = sharded_paths(mesh)
            for name in sharded:
                profile_path(name, runners[name], device)
    if args.parent:
        compare_tiles(args.parent)
    if args.b2_forms:
        compare_b2_forms(device)
    if args.b1_paths:
        compare_b1_paths(device)
    if args.b1_forms:
        compare_b1_forms(device)
    if args.kernel_split:
        kernel_split(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
