#!/usr/bin/env python3
"""Smoke run of qinfer_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Exits 1 when torch sees no CUDA device.
2. build: compiles both CUDA kernels from ``qinfer_tpu_torch/csrc`` with
   nvcc for sm_90a (into ``build/qinfer_tpu_torch/``).
3. compare: each kernel against its plain PyTorch version on the card —
   B1 (fused Bayes update) within the tolerances of the JAX package's own
   kernel test (atol 1e-4 on log-weights and log_norm, rtol 1e-3 on ESS),
   B2 (systematic expand) bit for bit.
4. main path: ``SMCUpdater`` with 2^20 particles on ``SimplePrecessionModel``
   and the Liu–West resampler, one warm-up window and three timed windows,
   each a ``batch_update`` over the 100-experiment record of ``bench.py``;
   every window must pass the bench's accuracy gate, and both kernels'
   launch counters must have moved during the timed windows.
5. timing: each kernel against its plain version at 2^20, with CUDA events.

The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import _build
from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import resample_expand as b2
from qinfer_tpu_torch.resamplers import systematic_segment_starts

N_FLAGSHIP = 1 << 20
N_EXP = 100
TRUE_OMEGA = 0.70710678
GATE = 0.05
B1_TOL = {"lw_atol": 1e-4, "log_norm_atol": 1e-4, "ess_rtol": 1e-3}


def experiment_record(n_exp, seed):
    """bench.py's record: exp-sparse times and outcomes drawn for TRUE_OMEGA."""
    rng = np.random.default_rng(seed)
    ts = np.minimum((9 / 8) ** np.arange(n_exp), 1e4).astype(np.float32)
    p0 = np.cos(0.5 * TRUE_OMEGA * ts) ** 2
    outcomes = (rng.random(n_exp) >= p0).astype(np.int32)
    return ts, outcomes


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    _, info = _build.library()
    print(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["report"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _b1_inputs(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    omega = torch.rand(n, generator=g, device=device)
    lw = torch.log(torch.rand(n, generator=g, device=device))
    return omega, lw - torch.logsumexp(lw, 0)


def phase_compare_b1(device):
    tile = b1.two_outcome_tile(b1.precession_pr1)
    worst = 0.0
    for n in (1000, N_FLAGSHIP + 3, N_FLAGSHIP):
        omega, lw = _b1_inputs(n, n, device)
        for outcome in (0, 1):
            for t in (2.0, 17.3):
                scal = torch.tensor([float(outcome), t], device=device)
                lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw,
                                                          (omega,))
                lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw,
                                                              (omega,))
                lw_p = lw_p - lse_p
                torch.cuda.synchronize()
                err = float(torch.max(torch.abs(lw_k - lw_p)))
                ln_err = abs(float(ln_k) - float(lse_p))
                ess_rel = abs(float(ess_k) / float(ess_p) - 1.0)
                ok = (err <= B1_TOL["lw_atol"]
                      and ln_err <= B1_TOL["log_norm_atol"]
                      and ess_rel <= B1_TOL["ess_rtol"]
                      and bool(torch.isfinite(lw_k).all()))
                print(f"B1 n={n} outcome={outcome} t={t}: max|dlw|={err:.3g}"
                      f" |dlog_norm|={ln_err:.3g} ess_rel={ess_rel:.3g}"
                      f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"B1 disagrees with its plain "
                                         f"version at n={n}")
                worst = max(worst, err, ln_err)
    return worst


def _weights(kind, n, rng):
    if kind == "random":
        w = rng.random(n) ** 3
    elif kind == "degenerate":  # all mass on particle 17
        w = np.zeros(n)
        w[17] = 1.0
    else:  # single heavy particle over a 1e-9 floor
        w = np.full(n, 1e-9)
        w[n // 2 + 1] = 1.0
    with np.errstate(divide="ignore"):
        return np.log(w / w.sum()).astype(np.float32)


def phase_compare_b2(device):
    worst = 0.0
    rng = np.random.default_rng(0)
    for n in (257, 16385, N_FLAGSHIP):
        for d in (1, 3):
            vals = torch.as_tensor(rng.standard_normal((n, d)),
                                   dtype=torch.float32, device=device)
            mu = torch.as_tensor(rng.standard_normal(d), dtype=torch.float32,
                                 device=device)
            for kind in ("random", "degenerate", "single_heavy"):
                log_w = torch.as_tensor(_weights(kind, n, rng), device=device)
                starts = systematic_segment_starts(log_w, n, u0=0.37)
                for affine in (False, True):
                    scale, shift = (0.98, 0.02 * mu) if affine else (None, None)
                    out_k = b2.expand_sorted_segments(starts, vals,
                                                      scale=scale, shift=shift)
                    out_p = b2.expand_plain(starts, vals, n,
                                            b2._affine(scale, shift, d, device))
                    torch.cuda.synchronize()
                    same = torch.equal(out_k, out_p)
                    print(f"B2 n={n} D={d} {kind} affine={affine}: "
                          f"{'bit-equal' if same else 'FAIL'}")
                    if not same:
                        raise AssertionError(
                            f"B2 differs from its plain version at n={n} D={d}"
                            f" {kind} affine={affine}")
                    worst = max(worst, float(torch.max(torch.abs(out_k - out_p))))
    return worst


def _window(seed, record_seed, device):
    ts, outcomes = experiment_record(N_EXP, record_seed)
    updater = qt.SMCUpdater(
        qt.SimplePrecessionModel(), N_FLAGSHIP, qt.UniformDistribution([0, 1]),
        zero_weight_policy="reset", seed=seed, device=device,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    updater.batch_update(outcomes, {"t": ts})
    est = float(updater.est_mean()[0])  # forces the window to finish
    seconds = time.perf_counter() - t0
    locs = updater.particle_locations
    if locs.shape != (N_FLAGSHIP, 1) or not bool(torch.isfinite(locs).all()):
        raise AssertionError("posterior cloud is not finite of shape (2^20, 1)")
    if not abs(est - TRUE_OMEGA) < GATE:
        raise AssertionError(f"accuracy gate failed: est={est}")
    return seconds, est, updater.resample_count


def phase_main_path(device):
    _window(10_000, 0, device)  # warm-up
    b1.fused_bayes_update.launches = 0
    b2.expand_sorted_segments.launches = 0
    windows = [_window(1000 * (w + 1), w, device) for w in range(3)]
    launches = {"B1": b1.fused_bayes_update.launches,
                "B2": b2.expand_sorted_segments.launches}
    n_resamples = [w[2] for w in windows]
    if launches["B1"] != 3 * N_EXP:
        raise AssertionError(f"B1 launched {launches['B1']} times, expected "
                             f"one per update ({3 * N_EXP})")
    if sum(n_resamples) == 0 or launches["B2"] < sum(n_resamples):
        raise AssertionError(f"B2 launched {launches['B2']} times for "
                             f"{sum(n_resamples)} resamples")
    secs = [w[0] for w in windows]
    med = statistics.median(secs)
    summary = {
        "particle_updates_per_s": N_FLAGSHIP * N_EXP / med,
        "window_s": secs, "est": [w[1] for w in windows],
        "n_resamples": n_resamples, "launches": launches,
    }
    print(json.dumps({"main_path": summary}))
    return launches


def _time_ms(fn, iters):
    """Device time per call. A device-side sleep queued first lets the host
    enqueue every call before the device starts them, so the events time
    the device and not the host's launch rate. iters · (launches per call)
    must stay well under the ~1024 launches a stream queues, or the host
    blocks and the device waits on it again."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _alternate(plain, kernel, iters=20):
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_timing(device):
    tile = b1.two_outcome_tile(b1.precession_pr1)
    omega, lw = _b1_inputs(N_FLAGSHIP, 7, device)
    scal = torch.tensor([1.0, 17.3], device=device)

    def b1_plain():
        lw_u, lse, _, ess = b1.fused_update_plain(tile, scal, lw, (omega,))
        return lw_u - lse, lse, ess

    times = {"B1": _alternate(
        b1_plain, lambda: b1.fused_bayes_update(tile, scal, lw, (omega,)))}

    rng = np.random.default_rng(1)
    log_w = torch.as_tensor(_weights("random", N_FLAGSHIP, rng), device=device)
    starts = systematic_segment_starts(log_w, N_FLAGSHIP, u0=0.37)
    vals = torch.rand((N_FLAGSHIP, 1), device=device)
    affine = b2._affine(0.98, 0.02 * vals.mean(0), 1, device)
    times["B2"] = _alternate(
        lambda: b2.expand_plain(starts, vals, N_FLAGSHIP, affine),
        lambda: b2._expand_cuda(starts, vals, N_FLAGSHIP, affine))
    for name, (k, p) in times.items():
        print(f"{name} at 2^20: kernel {k:.4f} ms, plain {p:.4f} ms")
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    err = {"B1": phase_compare_b1(device), "B2": phase_compare_b2(device)}
    launches = phase_main_path(device)
    times = phase_timing(device)
    replaces = {"B1": "qinfer_tpu/ops/fused_update.py:36",
                "B2": "qinfer_tpu/ops/resample_expand.py:115"}
    names = {"B1": "fused_bayes_update", "B2": "expand_sorted_segments"}
    sources = {"B1": "qinfer_tpu_torch/csrc/fused_update.cu",
               "B2": "qinfer_tpu_torch/csrc/resample_expand.cu"}
    kernels = [
        {"name": names[k], "route": "cuda", "source": sources[k],
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": err[k], "ms": times[k][0], "plain_ms": times[k][1]}
        for k in ("B1", "B2")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
