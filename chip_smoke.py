#!/usr/bin/env python3
"""Smoke run of qinfer_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Exits 1 when torch sees no CUDA device.
2. build: compiles both CUDA kernels from ``qinfer_tpu_torch/csrc`` with
   nvcc for sm_90a (into ``build/qinfer_tpu_torch/``), and at once, with a
   second nvcc, the user model's library (B1's header with the functor
   ``LOST_VISIBILITY_SOURCE``, into ``build/qinfer_tpu_torch/user/``).
3. compare: each kernel against its plain PyTorch version on the card —
   B1 (fused Bayes update) within the tolerances of the JAX package's own
   kernel test (atol 1e-4 on log-weights and log_norm, rtol 1e-3 on ESS),
   for the flagship tile, for each of the ten tiles of ``ZOO`` and for the
   three Born-tile cases of ``TOMO`` (priors drawn on the card with
   ``GinibreDistribution``) at n ∈ {1000, 2^20 + 3, 2^20}; B1's row-span
   path (``SPAN_CASES``: banks of row stride 4, 5, 16, 17, offset views)
   also bit for bit against its per-column path, single and batched; at
   every B1 case the per-column path's one-launch form bit for bit
   against its two-pass form, both forced (lw − lse, lse, lse2, ESS and
   the raw lw of ``return_stats``); B2 (systematic expand) bit for bit at
   D ∈ {1, 2, 3, 4, 5, 16, 17}, in the wrapper's form (the merge path up
   to D = 8) and, up to D = 8, in the rows form forced.
4. main path: ``SMCUpdater`` with 2^20 particles on ``SimplePrecessionModel``
   and the Liu–West resampler, one warm-up window and three timed windows,
   each a ``batch_update`` over the 100-experiment record of ``bench.py``;
   every window must pass the bench's accuracy gate, and both kernels'
   launch counters must have moved during the timed windows.
5. config paths: BASELINE configs 2–4 (``CONFIGS``) the same way at 2^20,
   each window gated by its example's accuracy check; B1 must launch
   exactly once per update and B2 at least once per resample. One JSON
   line per config.
6. config5_adaptive_tomography: BASELINE config 5 at 2^20 — a qubit,
   ``TomographyModel`` over ``pauli_basis(1)``, a Ginibre prior, and per
   step ``expected_information_gain`` over three candidate effects, the
   argmax on the host, an outcome drawn with numpy and ``update`` (B1 with
   the Born tile, B2 at D = 4). A warm-up window and three timed windows
   of 80 steps, seeds 0–3. Each window is gated: x̂ within three posterior
   standard deviations of the truth (‖x̂ − x‖ < 3·√tr Σ̂), the posterior
   concentrated (√tr Σ̂ < 0.25; the prior's is 0.55), x̂ physical, and
   every IG finite of shape (3,). One JSON line.
7. tomography_2q_binomial: two-qubit tomography, ``BinomialModel`` over
   ``TomographyModel(pauli_basis(2))`` (B1's binomial Born tile at 16
   columns, B2 at D = 16), one ``batch_update`` over 120 product
   projectors × 50 shots per window; gate: x̂ physical and Tr(ρ̂ρ) > 0.45.
   One JSON line.
8. config1_quickstart_pgh and config4_known_t2_pgh (``PGH_PATHS``): the
   adaptive loops of examples/config1 and examples/config4's known-T2 at
   2^20, 100 steps of ``PGH`` → ``simulate_experiment`` on the card →
   ``update`` per window; a warm-up window and three timed ones, each
   gated |est − ω| < 6σ + slack; B1 once per update, B2 at least once per
   resample. One JSON line each.
9. ensemble_small (256 × 2048 × 100) and ensemble_big (4 × 2^18 × 50),
   ``ENSEMBLES``: ``perf_test_multiple`` with ``PGH`` on the card, three
   runs each, gated on the median final loss (< 1e-3); the batched B1
   launches exactly once per step for all trials, the batched B2 at least
   once per step that resampled. One JSON line each, with the ensemble
   particle-updates/s T·N·n_exp / wall.
10. engine API (``phase_engine_api``), four paths at 2^20 with
   ``LiuWestResampler(a=0.98)`` and ``zero_weight_policy="reset"``, one
   JSON line each with its seconds, gate values and launches:
   ``flagship_bcrb`` (``SMCUpdaterBCRB`` over the flagship record, one
   ``update`` per experiment; gate BIM = Σ t² within 1e-3, the accuracy
   gate, posterior variance > 0.1 · BCRB), ``flagship_track_rsd``
   (``batch_update`` with ``track_resampling_divergence``; one finite
   divergence ≥ −1e-9 per resample), ``mixed_ale``
   (``MixedApproximateSMCUpdater`` with ``ALEApproximateModel`` over the
   precession model until ESS < 0.9·N; switched, accurate; B1 on the
   updates after the switch only, and ALE's batches and seconds per call
   on their own line) and ``posterior_summaries`` (one config4_multicos2
   window, then each summary timed: the credible set within ±1 of an f64
   NumPy recomputation, the truth in the 0.99 hpd-hull region, the
   marginal integrating to 1 within 1e-5, the mesh finite, the mean of
   2^16 samples within 5 standard errors). B1 once per update on the
   exact model, B2 at least once per resample.
11. model zoo (``phase_model_zoo``, ``ZOO_PATHS``), three paths at 2^20
   with ``LiuWestResampler(a=0.98)`` and ``zero_weight_policy="reset"``,
   a warm-up window and three timed ones each, every window gated, one
   JSON line each with window ms, resamples, redraw rounds and launches:
   ``random_walk_tracking`` (``RandomWalkModel`` over the binomial
   precession model, 1000 ``update`` steps tracking a walking ω; RMS error
   over the second half < 0.06), ``gaussian_walk_drift``
   (``GaussianRandomWalkModel`` learning its step scale, one
   ``batch_update`` of 400 single shots) and ``multinomial_die``
   (``MultinomialModel(NDieModel(3))``, one ``batch_update`` of 100 count
   vectors: vector outcomes through the step). None of these models has a
   B1 tile, so B1 must launch 0 times (the step updates them unfused, as
   the JAX package's does); B2 at least once per resample (D = 1, 2, 3).
   Then (``phase_samplers``) the samplers that loop per draw on the card
   (the multinomial ladder, Beta, BetaBinomial, Poisson) against their
   exact means at 2^20 draws, and two binomial calls in a row uncorrelated.
12. distributed layer (``qinfer_tpu_torch.parallel``). First
   (``phase_compare_sharded``) B2 on every rank's window of a 2^20 bank
   spread over K ∈ {2, 4, 8} ranks (``shard_windows``: the all-gather
   migration's starts, one bank's, shifted by each window's origin and
   clamped at 0), D ∈ {1, 4}, three weight kinds: each window bit-equal
   to its plain version in the wrapper's form and in the rows form
   forced, and the windows together bit-equal to one bank's
   ``systematic_expand``; and B1's raw statistics (``return_stats``) on K
   slices merged as the sharded step merges them, within ``B1_TOL`` of
   the one-bank launch (precession and born4). Then (``phase_sharded``)
   an NCCL process group of one rank (a file store in a temporary
   directory, destroyed whatever happens) runs four paths at 2^20, one
   JSON line each with the card: ``sharded_flagship`` (the flagship
   record through ``make_sharded_update_step``, all-gather migration; a
   warm-up and three gated windows; B1 once per update, B2 at least once
   per resample), ``sharded_flagship_ring`` (one window, ring migration,
   B2 0 times), ``sharded_config1_pgh`` and ``sharded_config5_eig``
   (``make_sharded_adaptive_episode`` with the sharded PGH and greedy EIG
   proposes, gated as config 1's PGH loop and config 5). Then
   (``phase_aux``) ``ThroughputMeter``, ``trace`` and ``annotate`` around
   one flagship window (a non-empty trace holding the annotation), and a
   CUDA updater's ``save_npz`` → ``load_npz`` → ``batch_update`` bit-equal
   to the uninterrupted run.
13. a user's own model (``LostVisibilityModel``, defined in this script
   as a user would: precession with lost visibility, Pr(1) = v·(1 −
   cos²(ωt/2)) + (1 − v)/2 over (ω, v), prior U([0, 1] × [0.5, 1]), its
   torch pr1 and that pr1's CUDA functor). First every shipped path above
   must have taken 0 launches on a user library and 0 on the column route.
   Then (``phase_compare_user``) the user tile from its own library
   against its plain version, two-outcome and binomial, at n ∈ {1000,
   2^20 + 3, 2^20}; the column route (the torch-only twin: its pr1
   evaluated on the card, B1 on ``GivenPr1``) within ``B1_TOL`` of the user
   tile; the trial grid (``B1_BATCH_SHAPES``) per trial bit-equal to
   single-bank launches. Then (``phase_user_tile``, ``USER_PATHS``) three
   paths at 2^20, a warm-up and three gated windows each (|ω̂ − ω| < 0.05,
   v̂ within 4 posterior standard deviations): ``user_tile`` (single shots
   over the flagship record's times, ω = 0.70710678, v = 0.9) and
   ``user_tile_binomial`` (``BinomialModel`` over it, 24 experiments × 40
   shots) with B1 once an update on the user library, ``user_tile_column``
   (the first with the torch-only twin) with B1 once an update on the
   column route; and ``user_tile_ensemble`` (``perf_test_multiple``, 256 ×
   2048 × 100, PGH), gated on the median loss falling tenfold, the batched
   B1 once a step on the user library. One JSON line each.
14. timing: each kernel against its plain version at 2^20, with CUDA
   events: B1 with the flagship tile, every tile of ``ZOO`` and the two
   Born tiles of the paths; B2 at D = 1, 2, 3, 4 and 16, and beside it
   ``torch.repeat_interleave`` (the pick without the affine); the batched
   B1 in both ensemble regimes; the batched B2 on the inputs of each
   regime's median resample (``B2Capture``), checked bit-equal to its plain
   version there too; B2 on rank 1's window of a bank over 4 ranks
   (n_in = 2^20, n_out = 2^18, D = 1) beside ``repeat_interleave`` over
   the window's counts, and B1 with ``return_stats`` (precession, born4).
   Each timing of a dispatched form that replaced
   another (B1's one launch, B2's merge path) times the old form in the
   same turns (B1 two passes, B2 rows), printed with the form and grid
   the wrapper took on earlier JSON lines. The user tile's B1 at 2^20
   (two-outcome beside the built-in two-column multicos in the same turns,
   binomial, the column route beside B1 on ``GivenPr1`` alone) and its
   trial grid at 256 × 2048.

The compare phase also holds the batched kernels: batched B1 within
``B1_TOL`` of its plain version, bit-equal per trial to single-bank
launches and its one-launch form to its two-pass form
(``B1_BATCH_SHAPES``, three tiles), batched B2 bit-equal to its plain
version and to single-bank launches (``B2_BATCH_SHAPES``).

The last two lines are the kernel table (each kernel with its launches on
its path, its worst error, its time, its plain version's, the bound from
its bytes and operations, and the library call's time or null) and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import datetime
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import _build
from qinfer_tpu_torch import parallel as par
from qinfer_tpu_torch import tomography as tomo
from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import resample_expand as b2
from qinfer_tpu_torch.parallel import sharded_smc
from qinfer_tpu_torch.resamplers import systematic_segment_starts

N_FLAGSHIP = 1 << 20
N_EXP = 100
TRUE_OMEGA = 0.70710678
GATE = 0.05
B1_TOL = {"lw_atol": 1e-4, "log_norm_atol": 1e-4, "ess_rtol": 1e-3}


@dataclass(frozen=True)
class Config:
    """One BASELINE config path: model, prior box, record and gate. The
    gate holds |est − truth| < 6σ + slack on ``coords`` (sorted first when
    ``sort``: MultiCos is symmetric under relabelling)."""

    name: str
    model: object
    prior: tuple
    outcomes: np.ndarray
    expparams: dict
    truth: tuple
    slack: float
    coords: tuple
    sort: bool = False

    def gate(self, mean, cov):
        mean = np.asarray(mean, np.float64)
        sd = np.sqrt(np.clip(np.diag(np.asarray(cov, np.float64)), 0, None))
        truth = np.asarray(self.truth, np.float64)
        if self.sort:
            order = np.argsort(mean)
            mean, sd, truth = mean[order], sd[order], np.sort(truth)
        c = list(self.coords)
        return bool(np.all(np.abs(mean[c] - truth[c]) < 6 * sd[c]
                           + self.slack)), mean, sd


def config2_binomial_precession():
    """bench_configs.py:127-143; gate of examples/config2 (6σ + 1e-3)."""
    rng = np.random.default_rng(0)
    ts = np.minimum((9 / 8) ** np.arange(24), 1e2).astype(np.float32)
    counts = rng.binomial(40, 1 - np.cos(0.5 * 0.62 * ts) ** 2)
    return Config("config2_binomial_precession",
                  qt.BinomialModel(qt.SimplePrecessionModel()), ((0, 1),),
                  counts.astype(np.int32),
                  {"t": ts, "n_meas": np.full(24, 40, np.int32)},
                  (0.62,), 1e-3, (0,))


def config3_binomial_rb():
    """bench_configs.py:162-175, the 9-length record tiled to 27 updates;
    gate of examples/config3 on p (6σ + 1e-2)."""
    rng = np.random.default_rng(0)
    ms = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256], np.int32)
    counts = 300 - rng.binomial(300, 0.45 * 0.97 ** ms + 0.5)
    return Config("config3_binomial_rb",
                  qt.BinomialModel(qt.RandomizedBenchmarkingModel()),
                  ((0.85, 1.0), (0.2, 0.6), (0.3, 0.55)),
                  np.tile(counts, 3).astype(np.int32),
                  {"m": np.tile(ms, 3), "n_meas": np.full(27, 300, np.int32)},
                  (0.97, 0.45, 0.5), 1e-2, (0,))


def config4_multicos2():
    """examples/config4 multicos: Dirichlet-split exp-sparse times, 150
    experiments, outcomes drawn with numpy; gate 6σ + 2e-2 on the sorted
    mean."""
    rng = np.random.default_rng(0)
    ts = np.stack([min((9 / 8) ** (k // 2), 300.0) * rng.dirichlet([1, 1])
                   for k in range(150)]).astype(np.float32)
    p0 = np.cos(0.5 * ts.astype(np.float64) @ np.array([0.35, 0.75])) ** 2
    return Config("config4_multicos2", qt.MultiCosModel(n_terms=2),
                  ((0, 1), (0, 1)), (rng.random(150) >= p0).astype(np.int32),
                  {"ts": ts}, (0.35, 0.75), 2e-2, (0, 1), sort=True)


def config4_known_t2():
    """examples/config4 known-T2 (T2 = 100, ω = 0.44) at the fixed
    exp-sparse times t = min((9/8)^k, 1e3) in place of the PGH loop;
    gate 6σ + 5e-3."""
    rng = np.random.default_rng(0)
    ts = np.minimum((9 / 8) ** np.arange(100), 1e3).astype(np.float32)
    t = ts.astype(np.float64)
    p0 = (np.exp(-t / 100) * np.cos(0.5 * 0.44 * t) ** 2
          + 0.5 * (1 - np.exp(-t / 100)))
    return Config("config4_known_t2", qt.KnownT2PrecessionModel(t2=100.0),
                  ((0, 1),), (rng.random(100) >= p0).astype(np.int32),
                  {"t": ts}, (0.44,), 5e-3, (0,))


CONFIGS = (config2_binomial_precession, config3_binomial_rb,
           config4_multicos2, config4_known_t2)

# B1's tile zoo: the ten non-tomography cases of tests/test_pallas_ops.py
# (name, model, prior box, outcome, expparams of one experiment, line of
# the JAX tile in qinfer_tpu/ops/fused_update.py).
ZOO = (
    ("multicos", qt.MultiCosModel(n_terms=2), ((0, 1), (0, 1)), 1,
     {"ts": [[1.3, 0.4]]}, 286),
    ("known_t2", qt.KnownT2PrecessionModel(t2=30.0), ((0, 1),), 0,
     {"t": [7.0]}, 299),
    ("rb", qt.RandomizedBenchmarkingModel(),
     ((0.8, 1.0), (0.2, 0.5), (0.3, 0.5)), 1, {"m": [32]}, 311),
    ("binomial_precession", qt.BinomialModel(qt.SimplePrecessionModel()),
     ((0, 1),), 11, {"t": [2.0], "n_meas": [40]}, 259),
    ("binomial_rb", qt.BinomialModel(qt.RandomizedBenchmarkingModel()),
     ((0.8, 1.0), (0.2, 0.5), (0.3, 0.5)), 210,
     {"m": [16], "n_meas": [300]}, 259),
    ("rb_interleaved", qt.RandomizedBenchmarkingModel(interleaved=True),
     ((0.8, 1.0), (0.8, 1.0), (0.2, 0.5), (0.3, 0.5)), 1,
     {"m": [24], "reference": [0]}, 319),
    ("rb_interleaved_ref", qt.RandomizedBenchmarkingModel(interleaved=True),
     ((0.8, 1.0), (0.8, 1.0), (0.2, 0.5), (0.3, 0.5)), 0,
     {"m": [24], "reference": [1]}, 319),
    ("inversion", qt.SimpleInversionModel(), ((0, 1),), 0,
     {"w_": [0.3], "t": [4.0]}, 330),
    ("coin", qt.CoinModel(), ((0, 1),), 1, {"dummy": [0.0]}, 336),
    ("noisy_coin", qt.NoisyCoinModel(), ((0, 1),), 0,
     {"alpha": [0.9], "beta": [0.1]}, 342),
)
# The tile each config path runs.
CONFIG_TILE = {"config2_binomial_precession": "binomial_precession",
               "config3_binomial_rb": "binomial_rb",
               "config4_multicos2": "multicos",
               "config4_known_t2": "known_t2"}

# -- a user's own model: B1 on the model's own pr1 ----------------------------
#
# Written as a user of the library would write it, outside the package: a
# two-outcome model that defines ``_fused_pr1_parts`` with its own pr1 and,
# for the card, that pr1's CUDA functor. The JAX package traces the same
# ``jnp`` pr1 into its Pallas kernel.


def lost_visibility_pr1(scalars, off, omega, v):
    """Precession with lost visibility v: Pr(1) = v·(1 − cos²(ωt/2)) +
    (1 − v)/2; scalars tail = [t]; columns ω, v."""
    c = torch.cos(0.5 * omega * scalars[off])
    return v * (1.0 - c * c) + 0.5 * (1.0 - v)


# The same function as a CUDA functor, rounded as the torch pr1 computes it.
LOST_VISIBILITY_SOURCE = r"""
struct UserPr1 {
  static constexpr int kMinCols = 2, kMaxColsUsed = 2;
  float t;
  __device__ UserPr1(const float* s, const Consts&, int) : t(s[0]) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    const float v = c(1, i);
    const float p = one_minus_cos2(mul(mul(0.5f, c(0, i)), t));
    return add(mul(v, p), mul(0.5f, sub(1.0f, v)));
  }
};
"""

LOST_VISIBILITY_CUDA = b1.cuda_pr1(lost_visibility_pr1, LOST_VISIBILITY_SOURCE)
LOST_VISIBILITY_TORCH = lost_visibility_pr1  # torch only: the column route


@dataclass(frozen=True, eq=False)
class LostVisibilityModel(qt.FiniteOutcomeModel):
    """Precession with lost visibility: parameters (ω, v), expparams t,
    Pr(1) = v·(1 − cos²(ωt/2)) + (1 − v)/2. ``pr1``: the pr1 that B1 runs
    (the CUDA functor, or the torch-only twin)."""

    pr1: object = LOST_VISIBILITY_CUDA

    @property
    def n_modelparams(self):
        return 2

    @property
    def modelparam_names(self):
        return ("omega", "v")

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def are_models_valid(self, modelparams):
        v = modelparams[:, 1]
        return (modelparams[:, 0] >= 0.0) & (v >= 0.0) & (v <= 1.0)

    def canonicalize(self, modelparams):
        lo = torch.tensor([0.0, 0.0], device=modelparams.device)
        hi = torch.tensor([float("inf"), 1.0], device=modelparams.device)
        return torch.clamp(modelparams, lo, hi)

    def _t(self, expparams, device):
        t = qt.models.base.expparams_field(expparams, "t")
        return torch.as_tensor(t, device=device).to(torch.float32).reshape(-1)

    def pr0(self, modelparams, expparams):
        t = self._t(expparams, modelparams.device)
        return 1.0 - self.pr1(t[None, None, :], 0, modelparams[:, :1],
                              modelparams[:, 1:])

    def _fused_pr1_parts(self, modelparams, expparams):
        t = self._t(expparams, modelparams.device)
        return self.pr1, t, (modelparams[..., 0], modelparams[..., 1])


USER_TRUTH = (TRUE_OMEGA, 0.9)
USER_PRIOR = ((0.0, 1.0), (0.5, 1.0))
USER_V_SDS = 4.0  # v̂ within 4 posterior standard deviations of the truth


def user_pr1_f64(omega, v, t):
    return (v * (1.0 - np.cos(0.5 * omega * np.asarray(t, np.float64)) ** 2)
            + 0.5 * (1.0 - v))


def user_records():
    """The user model's records: single shots at the flagship record's
    times (``experiment_record``'s), and config 2's record shape (24
    experiments × 40 shots at t = min((9/8)^k, 100)), outcomes drawn with
    numpy at ``USER_TRUTH``. Returns ((ts, outcomes), (ts, counts))."""
    rng = np.random.default_rng(0)
    ts = np.minimum((9 / 8) ** np.arange(N_EXP), 1e4).astype(np.float32)
    shots = (rng.random(N_EXP) < user_pr1_f64(*USER_TRUTH, ts)).astype(np.int32)
    tb = np.minimum((9 / 8) ** np.arange(24), 1e2).astype(np.float32)
    counts = rng.binomial(40, user_pr1_f64(*USER_TRUTH, tb)).astype(np.int32)
    return (ts, shots), (tb, counts)


# (name, model, record, shots a count): the user model's three windows.
USER_PATHS = (
    ("user_tile", LostVisibilityModel(), 0, None),
    ("user_tile_binomial", qt.BinomialModel(LostVisibilityModel()), 1, 40),
    ("user_tile_column", LostVisibilityModel(LOST_VISIBILITY_TORCH), 0, None),
)


def user_record(record, n_meas):
    """(outcomes, expparams) of one of ``user_records``, with ``n_meas``
    shots a count (None: single shots)."""
    ts, outcomes = user_records()[record]
    if n_meas is None:
        return outcomes, {"t": ts}
    return outcomes, {"t": ts, "n_meas": np.full(len(ts), n_meas, np.int32)}


def user_window(model, record, n_meas, n, seed, device, **kw):
    """One ``batch_update`` of the user model over its record; returns
    (seconds, est, sd, resamples). Gated: |ω̂ − ω| < GATE and v̂ within
    USER_V_SDS posterior standard deviations of the truth. ``kw``: more
    arguments of the updater."""
    outcomes, ep = user_record(record, n_meas)
    u = qt.SMCUpdater(model, n, qt.UniformDistribution(USER_PRIOR),
                      zero_weight_policy="reset", seed=seed, device=device,
                      **kw)
    _sync(device)
    t0 = time.perf_counter()
    u.batch_update(outcomes, ep)
    est = u.est_mean().cpu().numpy().astype(np.float64)  # ends the window
    seconds = time.perf_counter() - t0
    sd = np.sqrt(np.diag(u.est_covariance_mtx().cpu().numpy()).astype(
        np.float64))
    locs = u.particle_locations
    if locs.shape != (n, 2) or not bool(torch.isfinite(locs).all()):
        raise AssertionError("user model: posterior cloud is not finite of "
                             f"shape ({n}, 2)")
    if not (abs(est[0] - USER_TRUTH[0]) < GATE
            and abs(est[1] - USER_TRUTH[1]) < USER_V_SDS * sd[1]):
        raise AssertionError(f"user model: gate failed: est={est} sd={sd} "
                             f"truth={USER_TRUTH}")
    return seconds, est.tolist(), sd.tolist(), u.resample_count


def user_inputs(binomial, n, seed, device):
    """(tile, scalars, log_w, cols) of the user tile on a bank drawn from
    the user prior: two-outcome, outcome 1 at t = 7.3, or binomial, 27 of
    40 at t = 3.1."""
    g = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([b[0] for b in USER_PRIOR], device=device)
    hi = torch.tensor([b[1] for b in USER_PRIOR], device=device)
    locs = lo + (hi - lo) * torch.rand((n, 2), generator=g, device=device)
    lw = torch.log(torch.rand(n, generator=g, device=device))
    if binomial:
        model, outcome = USER_PATHS[1][1], 27
        ep = {"t": torch.tensor([3.1], device=device),
              "n_meas": torch.tensor([40], device=device)}
    else:
        model, outcome = USER_PATHS[0][1], 1
        ep = {"t": torch.tensor([7.3], device=device)}
    tile, scal, cols = model.fused_spec(outcome, locs, ep)
    return tile, scal, lw - torch.logsumexp(lw, 0), cols


def user_batched_inputs(n_trials, n, seed, device):
    """(tile, scalars (T, k), log_w (T, N), cols) of the user tile on T
    banks drawn from the user prior, one experiment (t ∈ [1, 21]) and one
    outcome per trial, from ``fused_spec_batched``."""
    g = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([b[0] for b in USER_PRIOR], device=device)
    hi = torch.tensor([b[1] for b in USER_PRIOR], device=device)
    locs = lo + (hi - lo) * torch.rand((n_trials, n, 2), generator=g,
                                       device=device)
    ep = {"t": 1.0 + 20.0 * torch.rand(n_trials, generator=g, device=device)}
    outcomes = torch.randint(0, 2, (n_trials,), generator=g, device=device)
    lw = torch.log(1.0 - torch.rand((n_trials, n), generator=g,
                                    device=device))
    tile, scal, cols = USER_PATHS[0][1].fused_spec_batched(outcomes, locs, ep)
    return tile, scal, lw - torch.logsumexp(lw, 1, keepdim=True), cols


# -- tomography (BASELINE config 5 and two qubits) ----------------------------

PAULI1 = tomo.pauli_basis(1)
PAULI2 = tomo.pauli_basis(2)
# examples/config5_adaptive_tomography.py:23-37: a slightly mixed |+⟩ and
# the projectors onto the +X, +Y and +Z eigenstates.
TRUE_RHO_1Q = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
PROJECTORS_1Q = (np.array([[0.5, 0.5], [0.5, 0.5]]),
                 np.array([[0.5, -0.5j], [0.5j, 0.5]]),
                 np.array([[1, 0], [0, 0]]))
N_STEPS_1Q = 80
# The config-5 gate. The example's fixed bound ‖x̂ − x‖ < 0.2 was set for
# 160 steps; after 80 single shots √tr Σ̂ is 0.15–0.21, and a fixed 0.2
# fails about one seed in four by statistics alone. The gate therefore
# holds the error against the posterior's own spread (Z_1Q standard
# deviations), and the spread against a bound (SPREAD_1Q) under half the
# Ginibre prior's 0.55, so that the window must also have learned.
Z_1Q = 3.0
SPREAD_1Q = 0.25
# Seeds (the updater's and numpy's outcome draws) of the warm-up and the
# three timed windows.
CONFIG5_SEEDS = (0, 1, 2, 3)
N_2Q = 1 << 20
N_SETTINGS_2Q, N_SHOTS_2Q = 120, 50
GATE_2Q = 0.45


def coords(basis, rho):
    """Coordinates (d²,) of one operator as a numpy f32 vector."""
    return basis.state_to_modelparams(
        np.asarray(rho, np.complex64)[None])[0].numpy()


TRUE_X_1Q = coords(PAULI1, TRUE_RHO_1Q)
EFFECTS_1Q = np.stack([coords(PAULI1, P) for P in PROJECTORS_1Q])


def _pure_state(rng):
    v = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    v = v / np.linalg.norm(v)
    return np.outer(v, v.conj())


def product_projector_2q(rng):
    """Coordinates of |a⟩⟨a| ⊗ |b⟩⟨b| for two pure states drawn as
    normalised complex Gaussians."""
    return coords(PAULI2, np.kron(_pure_state(rng), _pure_state(rng)))


def tomography_2q_record(seed=0):
    """tests/test_compat_and_multiqubit.py:44-92: the state
    0.9|Φ⁺⟩⟨Φ⁺| + 0.1·I/4 and 120 random product projectors × 50 shots.
    Returns (true ρ, its coordinates, meas (120, 16), counts (120,))."""
    phi = np.zeros((4, 1), dtype=np.complex64)
    phi[0, 0] = phi[3, 0] = 1 / np.sqrt(2)
    rho = (0.9 * (phi @ phi.conj().T) + 0.1 * np.eye(4) / 4).astype(
        np.complex64)
    true_x = coords(PAULI2, rho)
    rng = np.random.default_rng(seed)
    meas = np.stack([product_projector_2q(rng)
                     for _ in range(N_SETTINGS_2Q)])
    pr1 = np.clip(meas.astype(np.float64) @ true_x, 0, 1)
    counts = rng.binomial(N_SHOTS_2Q, pr1).astype(np.int32)
    return rho, true_x, meas, counts


class DiffusivePrior(qt.Distribution):
    """Ginibre coordinates and a diffusion rate ε ~ U[0, 0.05]
    (tests/test_pallas_ops.py:234-246)."""

    def __init__(self, basis):
        self.states = tomo.GinibreDistribution(basis)

    def sample(self, generator, n=1):
        x = self.states.sample(generator, n)
        eps = 0.05 * torch.rand((n, 1), generator=generator,
                                device=generator.device)
        return torch.cat([x, eps], dim=1)


_E_BORN = np.array([1, 1, 0, 0], np.float32) / np.float32(2 * np.sqrt(2))
# B1's Born-tile cases: (name, model, prior, outcome, expparams of one
# experiment). The first two are tests/test_pallas_ops.py:281-286; the third
# is one update of the two-qubit path (a product projector, k = 31 of 50).
TOMO = (
    ("tomography", tomo.TomographyModel(PAULI1),
     tomo.GinibreDistribution(PAULI1), 1, {"meas": _E_BORN[None]}),
    ("diffusive_tomography", tomo.DiffusiveTomographyModel(PAULI1),
     DiffusivePrior(PAULI1), 1,
     {"meas": _E_BORN[None], "t": np.array([1.0], np.float32)}),
    ("binomial_tomography_2q",
     qt.BinomialModel(tomo.TomographyModel(PAULI2)),
     tomo.GinibreDistribution(PAULI2), 31,
     {"meas": product_projector_2q(np.random.default_rng(3))[None],
      "n_meas": np.array([50], np.int32)}),
)
# The tile each tomography path runs, under its name in the kernel table.
TOMO_TILE = {"config5_adaptive_tomography": ("tomography", "born4"),
             "tomography_2q_binomial": ("binomial_tomography_2q",
                                        "binomial_born16")}


def zoo_inputs(case, n, seed, device):
    """(tile, scalars, log_w, cols) of a ZOO case on a bank drawn from
    its prior box."""
    _, model, box, outcome, ep, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([b[0] for b in box], device=device)
    hi = torch.tensor([b[1] for b in box], device=device)
    locs = lo + (hi - lo) * torch.rand((n, len(box)), generator=g,
                                       device=device)
    lw = torch.log(torch.rand(n, generator=g, device=device))
    ep = {k: torch.tensor(v, device=device) for k, v in ep.items()}
    tile, scal, cols = model.fused_spec(outcome, locs, ep)
    return tile, scal, lw - torch.logsumexp(lw, 0), cols


def tomo_inputs(case, n, seed, device):
    """(tile, scalars, log_w, cols) of a TOMO case on a bank drawn from
    its prior on ``device``."""
    _, model, prior, outcome, ep = case
    g = torch.Generator(device=device).manual_seed(seed)
    locs = prior.sample(g, n)
    lw = torch.log(torch.rand(n, generator=g, device=device))
    ep = {k: torch.as_tensor(v, device=device) for k, v in ep.items()}
    tile, scal, cols = model.fused_spec(outcome, locs, ep)
    return tile, scal, lw - torch.logsumexp(lw, 0), cols


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def config5_updater(n, seed, device):
    """examples/config5_adaptive_tomography.py:17-20 with n particles and
    zero_weight_policy="reset"."""
    return qt.SMCUpdater(tomo.TomographyModel(PAULI1), n,
                         tomo.GinibreDistribution(PAULI1),
                         zero_weight_policy="reset", seed=seed, device=device)


def config5_window(u, rng_seed, n_steps=N_STEPS_1Q):
    """One adaptive window of BASELINE config 5 on updater ``u``: per step
    the EIG of the three candidate effects, the argmax on the host, an
    outcome drawn with numpy from clip(x·e, 0, 1), and one update. Returns
    the window's record and timings."""
    device = u.device
    cand = {"meas": torch.as_tensor(EFFECTS_1Q, device=device)}
    rng = np.random.default_rng(rng_seed)
    choices, outcomes, igs = [], [], []
    eig_s = update_s = 0.0
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ta = time.perf_counter()
        ig = u.expected_information_gain(cand).cpu().numpy()
        tb = time.perf_counter()
        k = int(np.argmax(ig))
        pr1 = float(np.clip(TRUE_X_1Q @ EFFECTS_1Q[k], 0, 1))
        outcome = 1 if rng.random() < pr1 else 0
        u.update(outcome, {"meas": cand["meas"][k:k + 1]})
        _sync(device)
        tc = time.perf_counter()
        eig_s += tb - ta
        update_s += tc - tb
        choices.append(k)
        outcomes.append(outcome)
        igs.append(ig)
    est = u.est_mean().cpu().numpy()  # forces the window to finish
    seconds = time.perf_counter() - t0
    spread = float(np.sqrt(np.trace(u.est_covariance_mtx().cpu().numpy())))
    return {"updater": u, "seconds": seconds, "est": est, "spread": spread,
            "choices": choices, "outcomes": outcomes, "igs": igs,
            "eig_ms_per_step": 1e3 * eig_s / n_steps,
            "update_ms_per_step": 1e3 * update_s / n_steps}


def config5_gate(window):
    """‖x̂ − x‖ < Z_1Q·√tr Σ̂, √tr Σ̂ < SPREAD_1Q, x̂ physical, every IG
    finite of shape (3,). Returns (ok, ‖x̂ − x‖, √tr Σ̂)."""
    est, spread = window["est"], window["spread"]
    err = float(np.linalg.norm(est - TRUE_X_1Q))
    model = window["updater"].model
    physical = bool(model.are_models_valid(
        torch.as_tensor(est[None]))[0])
    igs_ok = all(ig.shape == (3,) and np.all(np.isfinite(ig))
                 for ig in window["igs"])
    ok = err < Z_1Q * spread and spread < SPREAD_1Q and physical and igs_ok
    return ok, err, spread


def tomography_2q_updater(n, seed, device):
    return qt.SMCUpdater(qt.BinomialModel(tomo.TomographyModel(PAULI2)), n,
                         tomo.GinibreDistribution(PAULI2),
                         zero_weight_policy="reset", seed=seed, device=device)


def tomography_2q_expparams(meas):
    return {"meas": meas, "n_meas": np.full(len(meas), N_SHOTS_2Q, np.int32)}


def tomography_2q_window(u):
    """One batch_update of the two-qubit record on updater ``u``. Returns
    the window's time and estimate."""
    _, _, meas, counts = tomography_2q_record()
    _sync(u.device)
    t0 = time.perf_counter()
    u.batch_update(counts, tomography_2q_expparams(meas))
    est = u.est_mean().cpu().numpy()  # forces the window to finish
    return {"updater": u, "seconds": time.perf_counter() - t0, "est": est}


def tomography_2q_gate(window):
    """x̂ physical and Tr(ρ̂ρ) > 0.45. Returns (ok, overlap)."""
    rho, _, _, _ = tomography_2q_record()
    est = window["est"]
    physical = bool(tomo.TomographyModel(PAULI2).are_models_valid(
        torch.as_tensor(est[None]))[0])
    overlap = float(np.real(np.trace(PAULI2.modelparams_to_state(est) @ rho)))
    return physical and overlap > GATE_2Q, overlap


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
    """Builds the built-in library and the user model's library
    (``LOST_VISIBILITY_SOURCE``) at once, one nvcc each; prints each
    library's build seconds and each kernel's registers and spills from
    ptxas, labelled Outcome<Pr1> for B1's instantiations (Outcome<UserPr1>
    for the user functor's)."""
    with ThreadPoolExecutor(2) as pool:
        builtin = pool.submit(_build.library)
        user = pool.submit(_build.user_library, LOST_VISIBILITY_SOURCE)
        infos = {"build": builtin.result()[1], "build user": user.result()[1]}
    for label, info in infos.items():
        print(f"{label}: {info['seconds']:.1f} s -> {info['path']}")
        _print_ptxas(info["report"])


def _print_ptxas(report):
    kernel = "?"
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(TwoOutcome|Binomial)INS_\d+(\w+?Pr1)"
                          r"(?:ILi(\d+)E)?E", line)
            bound = f"<{m.group(3)}>" if m and m.group(3) else ""
            if "fused_update_span" in line:
                form = (" [row span, float4]" if "Lb1E" in line
                        else " [row span]")
            elif "fused_update_one" in line:
                form = (" [one launch, trial grid]" if "Lb1E" in line
                        else " [one launch]")
            else:
                form = " [trial grid]" if "Lb1E" in line else ""
            merge = re.search(r"expand_mergeILi(\d+)E", line)
            b2_form = ("expand_rows" if "expand_rows" in line
                       else "expand_merge<{}{}>".format(
                           merge.group(1), ", vector" if "Lb1E" in line
                           else "") if merge
                       else "expand_span<float4>" if "Lb1E" in line
                       else "expand_span")
            kernel = (f"{m.group(1)}<{m.group(2)}{bound}>{form}" if m
                      else "fused_update_pass2" if "pass2" in line
                      else b2_form)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}:", line.split(":", 1)[-1].strip())


def _b1_inputs(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    omega = torch.rand(n, generator=g, device=device)
    lw = torch.log(torch.rand(n, generator=g, device=device))
    return omega, lw - torch.logsumexp(lw, 0)


def both_forms(tile, scal, lw, cols):
    """B1 on T banks through the per-column path's one-launch and two-pass
    forms, forced, on the same inputs: per form (lw − lse, lse, lse2, ess,
    raw lw as ``return_stats`` gives it)."""
    out = []
    for form in (b1.ONE_LAUNCH, b1.TWO_PASS):
        norm = b1._fused_update_cuda(tile, scal, lw, cols, row_span=False,
                                     form=form, normalize=True)
        raw = b1._fused_update_cuda(tile, scal, lw, cols, row_span=False,
                                    form=form)[0]
        out.append((*norm, raw))
    return out


def _forms_check(label, tile, scal, lw, cols):
    """The one-launch form bit-equal to the two-pass form on T banks; raises
    otherwise."""
    one, two = both_forms(tile, scal, lw, cols)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(one, two))
    print(f"B1 {label}: one launch and two passes "
          f"{'bit-equal (lw − lse, lse, lse2, ess, raw lw)' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"B1's one-launch form differs from its "
                             f"two-pass form: {label}")


def _agree(label, got, want, note=""):
    """Two (lw, log_norm, ess) results, single bank or T banks, within
    B1_TOL and ``got`` finite; raises otherwise and returns the larger of
    max |Δ lw| and max |Δ log_norm|. ``note`` is printed after a pass."""
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got[0] - want[0])))
    ln_err = float(torch.max(torch.abs(got[1] - want[1])))
    ess_rel = float(torch.max(torch.abs(got[2] / want[2] - 1.0)))
    ok = (err <= B1_TOL["lw_atol"] and ln_err <= B1_TOL["log_norm_atol"]
          and ess_rel <= B1_TOL["ess_rtol"]
          and bool(torch.isfinite(got[0]).all()))
    same = err == 0.0 and ln_err == 0.0
    print(f"B1 {label}: max|dlw|={err:.3g} |dlog_norm|={ln_err:.3g}"
          f" ess_rel={ess_rel:.3g}{note if ok else ''} {'ok' if ok else 'FAIL'}"
          f"{' (lw, log_norm bit-equal)' if same else ''}")
    if not ok:
        raise AssertionError(f"B1 disagrees: {label}")
    return max(err, ln_err)


def _b1_check(label, tile, scal, lw, cols):
    """Kernel against plain on one input, and its two per-column forms
    against each other; raises on disagreement and returns the larger of
    max |Δ lw| and |Δ log_norm| against plain."""
    _forms_check(label, tile, scal[None], lw[None], tuple(c[None] for c in cols))
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    return _agree(label, b1.fused_bayes_update(tile, scal, lw, cols),
                  (lw_p - lse_p, lse_p, ess_p))


def phase_compare_b1(device):
    tile = b1.two_outcome_tile(b1.precession_pr1)
    worst = 0.0
    for n in (1000, N_FLAGSHIP + 3, N_FLAGSHIP):
        omega, lw = _b1_inputs(n, n, device)
        for outcome in (0, 1):
            for t in (2.0, 17.3):
                scal = torch.tensor([float(outcome), t], device=device)
                worst = max(worst, _b1_check(
                    f"n={n} outcome={outcome} t={t}", tile, scal, lw,
                    (omega,)))
    return worst


def phase_compare_zoo(device):
    """Every ZOO tile against its plain version; worst error per tile."""
    worst = {}
    for case in ZOO:
        worst[case[0]] = max(
            _b1_check(f"{case[0]} n={n}", *zoo_inputs(case, n, n, device))
            for n in (1000, N_FLAGSHIP + 3, N_FLAGSHIP))
    return worst


def phase_compare_tomo(device):
    """Every TOMO case against its plain version; worst error per case."""
    worst = {}
    for case in TOMO:
        worst[case[0]] = max(
            _b1_check(f"{case[0]} n={n}", *tomo_inputs(case, n, n, device))
            for n in (1000, N_FLAGSHIP + 3, N_FLAGSHIP))
    return worst


# B1's row-span path (columns that are views of one row-major (N, s)
# bank): (s, columns read, view). "rows" reads columns 0…k−1 of the bank,
# "from_row_1" the same of bank[1:], "from_col_1" columns 1…k. s = 4 and
# 16 are config 5's and the two-qubit bank; 5 and 17 the diffusive models'
# (ε unread). Below s = 8 the wrapper keeps the per-column path, so the
# compare forces each path on the same views.
SPAN_CASES = ((4, 4, "rows"), (5, 4, "rows"), (16, 16, "rows"),
              (17, 16, "rows"), (16, 16, "from_row_1"),
              (5, 4, "from_row_1"), (5, 4, "from_col_1"),
              (17, 16, "from_col_1"))


def span_inputs(s, k, view, n, seed, device, n_trials=None):
    """(tile, scalars, log_w, cols) of a binomial Born update whose k
    columns are views of one (n, s) bank (or (T, n, s) with ``n_trials``)
    of Ginibre-like draws; ``cols[j]`` is (n,) or (T, n)."""
    g = torch.Generator(device=device).manual_seed(seed)
    lead = () if n_trials is None else (n_trials,)
    rows = n + (view == "from_row_1")
    bank = 0.5 * torch.rand(lead + (rows, s), generator=g, device=device)
    bank = bank[..., 1:, :] if view == "from_row_1" else bank
    c0 = 1 if view == "from_col_1" else 0
    cols = tuple(bank[..., c0 + j] for j in range(k))
    meas = torch.rand(lead + (k,), generator=g, device=device) / k
    n_meas = 50.0
    count = torch.full(lead + (1,), 31.0, device=device)
    log_c = (torch.lgamma(torch.tensor(n_meas + 1.0, device=device))
             - torch.lgamma(count + 1.0) - torch.lgamma(n_meas - count + 1.0))
    scal = torch.cat([count, torch.full_like(count, n_meas), log_c, meas], -1)
    lw = torch.log(1.0 - torch.rand(lead + (n,), generator=g, device=device))
    return (b1.binomial_tile(b1.make_born_pr1(k)), scal,
            lw - torch.logsumexp(lw, -1, keepdim=True), cols)


def both_paths(tile, scal, lw, cols):
    """B1 on T banks through the row-span path and through the per-column
    path, forced, on the same columns: two (lw, lse, lse2, ess)."""
    return tuple(b1._fused_update_cuda(tile, scal, lw, cols, row_span=path)
                 for path in (True, False))


def phase_compare_span(device):
    """B1's row-span path on SPAN_CASES at n ∈ {1000, 2^20 + 3}: the
    wrapper's path within B1_TOL of the plain version, and the row-span
    path bit-equal (log-weights, lse, lse2, ESS) to the per-column path on
    the same views, for one bank and for T = 3. Returns the worst error."""
    worst = 0.0
    for s, k, view in SPAN_CASES:
        for n in (1000, N_FLAGSHIP + 3):
            label = f"row span s={s} k={k} {view} n={n}"
            tile, scal, lw, cols = span_inputs(s, k, view, n, n + s, device)
            worst = max(worst, _b1_check(label, tile, scal, lw, cols))
            span, per_col = both_paths(tile, scal[None], lw[None],
                                       tuple(c[None] for c in cols))
            batched = span_inputs(s, k, view, n, n + s, device, n_trials=3)
            span_t, per_col_t = both_paths(*batched)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(span, per_col))
                    and all(torch.equal(a, b)
                            for a, b in zip(span_t, per_col_t)))
            print(f"B1 {label}: row span and per column "
                  f"{'bit-equal (single and T=3)' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"B1 row span differs from the "
                                     f"per-column path: {label}")
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


# B2's forms forced beside the wrapper's, above D = 8 and up to it.
B2_FORCED = {False: (), True: (b2.MERGE, b2.ROWS)}


def phase_compare_b2(device):
    """B2 bit-equal to its plain version: the wrapper's form and, up to
    D = 8, the merge path and the rows form forced."""
    worst = 0.0
    rng = np.random.default_rng(0)
    for n in (257, 16385, N_FLAGSHIP):
        for d in (1, 2, 3, 4, 5, 16, 17):
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
                    aff = b2._affine(scale, shift, d, device)
                    out_p = b2.expand_plain(starts, vals, n, aff)
                    forced = [b2._expand_cuda_batched(
                        starts[None], vals[None], n,
                        None if aff is None else aff[None], form=form)[0]
                        for form in B2_FORCED[d <= 8]]
                    torch.cuda.synchronize()
                    same = all(torch.equal(o, out_p) for o in [out_k] + forced)
                    print(f"B2 n={n} D={d} {kind} affine={affine}: wrapper's "
                          f"form {b2.kernel_form(d, 2 * n)} and forms "
                          f"{B2_FORCED[d <= 8]} forced "
                          f"{'bit-equal' if same else 'FAIL'}")
                    if not same:
                        raise AssertionError(
                            f"B2 differs from its plain version at n={n} D={d}"
                            f" {kind} affine={affine}")
                    worst = max(worst, float(torch.max(torch.abs(out_k - out_p))))
    return worst


# -- batched kernels (trial ensembles) ------------------------------------------

# (T, N) of the two ensemble regimes of bench_ensemble.py:54-58, and a
# ragged one.
B1_BATCH_SHAPES = ((256, 2048), (4, 1 << 18), (3, 1000 + 3))
B2_BATCH_SHAPES = ((256, 2048, 1), (4, 1 << 18, 1), (8, 4099, 4))


def batched_b1_inputs(name, n_trials, n, seed, device):
    """(tile, scalars (T, k), log_w (T, N), cols) of one batched B1 case:
    T banks drawn from the tile's prior, one experiment per trial, from
    ``model.fused_spec_batched``. ``name``: precession, multicos or born4."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    if name == "precession":
        model, locs = qt.SimplePrecessionModel(), rand(n_trials, n, 1)
        ep = {"t": 1.0 + 20.0 * rand(n_trials)}
    elif name == "multicos":
        model, locs = qt.MultiCosModel(n_terms=2), rand(n_trials, n, 2)
        ep = {"ts": 4.0 * rand(n_trials, 2)}
    else:
        model = tomo.TomographyModel(PAULI1)
        locs = tomo.GinibreDistribution(PAULI1).sample(
            g, n_trials * n).reshape(n_trials, n, 4)
        pick = torch.randint(0, 3, (n_trials,), generator=g, device=device)
        ep = {"meas": torch.as_tensor(EFFECTS_1Q, device=device)[pick]}
    outcomes = torch.randint(0, 2, (n_trials,), generator=g, device=device)
    lw = torch.log(1.0 - rand(n_trials, n))  # finite: 1 − U lies in (0, 1]
    tile, scal, cols = model.fused_spec_batched(outcomes, locs, ep)
    return tile, scal, lw - torch.logsumexp(lw, 1, keepdim=True), cols


def phase_compare_b1_batched(device):
    """Batched B1 against its plain version (within B1_TOL) and, trial by
    trial, against single-bank launches (log-weights and log_norm
    bit-equal), for three tiles at each B1_BATCH_SHAPES. Returns the worst
    error against the plain version."""
    worst = 0.0
    for name in ("precession", "multicos", "born4"):
        for n_trials, n in B1_BATCH_SHAPES:
            worst = max(worst, _b1_batched_check(
                f"{name} T={n_trials} N={n}",
                *batched_b1_inputs(name, n_trials, n, n_trials + n, device)))
    return worst


def _b1_batched_check(label, tile, scal, lw, cols):
    """Batched B1 on T banks: its two forms bit-equal, within B1_TOL of its
    plain version, and each trial bit-equal to a single-bank launch; raises
    otherwise, and returns the larger of max |Δ lw| and max |Δ log_norm|
    against plain."""
    _forms_check(f"batched {label}", tile, scal, lw, cols)
    got = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    for i in range(lw.shape[0]):
        lw_1, ln_1, _ = b1.fused_bayes_update(tile, scal[i], lw[i],
                                              tuple(c[i] for c in cols))
        if not (torch.equal(lw_1, got[0][i]) and torch.equal(ln_1, got[1][i])):
            raise AssertionError(f"batched B1 {label}: trial {i} differs "
                                 f"from a single-bank launch")
    lw_p, lse_p, _, ess_p = b1.fused_update_plain_batched(tile, scal, lw, cols)
    return _agree(f"batched {label}", got,
                  (lw_p - lse_p[:, None], lse_p, ess_p),
                  note=" per-trial single launches bit-equal")


def batched_b2_inputs(n_trials, n, d, seed, device):
    """(starts (T, N), values (T, N, D), μ (T, D)) with per-trial weights of
    the three kinds of ``_weights`` in turn."""
    rng = np.random.default_rng(seed)
    kinds = ("random", "degenerate", "single_heavy")
    log_w = torch.as_tensor(np.stack([_weights(kinds[i % 3], n, rng)
                                      for i in range(n_trials)]),
                            device=device)
    u0 = torch.as_tensor(rng.random(n_trials), dtype=torch.float32,
                         device=device)
    starts = qt.resamplers.systematic_segment_starts_batched(log_w, n, u0=u0)
    vals = torch.as_tensor(rng.standard_normal((n_trials, n, d)),
                           dtype=torch.float32, device=device)
    mu = torch.as_tensor(rng.standard_normal((n_trials, d)),
                         dtype=torch.float32, device=device)
    return starts, vals, mu


def phase_compare_b2_batched(device):
    """Batched B2 bit-equal to its plain version and to single-bank
    launches, with and without the per-trial affine."""
    for n_trials, n, d in B2_BATCH_SHAPES:
        starts, vals, mu = batched_b2_inputs(n_trials, n, d, n, device)
        for affine in (False, True):
            scale, shift = (0.98, 0.02 * mu) if affine else (None, None)
            out_k = b2.expand_sorted_segments_batched(starts, vals, scale=scale,
                                                      shift=shift)
            out_p = b2.expand_plain_batched(
                starts, vals, n,
                b2._affine_batched(scale, shift, n_trials, d, device))
            singles = torch.stack([b2.expand_sorted_segments(
                starts[i], vals[i], scale=scale,
                shift=None if shift is None else shift[i])
                for i in range(n_trials)])
            aff = b2._affine_batched(scale, shift, n_trials, d, device)
            forced = [b2._expand_cuda_batched(starts, vals, n, aff, form=form)
                      for form in B2_FORCED[d <= 8]]
            torch.cuda.synchronize()
            same = (torch.equal(out_k, out_p) and torch.equal(out_k, singles)
                    and all(torch.equal(o, out_p) for o in forced))
            print(f"B2 batched T={n_trials} N={n} D={d} affine={affine}: "
                  f"{'bit-equal to plain, single launches and forms ' if same else 'FAIL '}"
                  f"{B2_FORCED[d <= 8]} forced")
            if not same:
                raise AssertionError(f"batched B2 differs at T={n_trials} "
                                     f"N={n} D={d} affine={affine}")
    return 0.0


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


def _config_window(cfg, seed, device, n=N_FLAGSHIP):
    updater = qt.SMCUpdater(cfg.model, n,
                            qt.UniformDistribution(cfg.prior),
                            zero_weight_policy="reset", seed=seed,
                            device=device)
    _sync(device)
    t0 = time.perf_counter()
    updater.batch_update(cfg.outcomes, cfg.expparams)
    mean = updater.est_mean().cpu().numpy()  # forces the window to finish
    seconds = time.perf_counter() - t0
    cov = updater.est_covariance_mtx().cpu().numpy()
    locs = updater.particle_locations
    d = cfg.model.n_modelparams
    if locs.shape != (n, d) or not bool(torch.isfinite(locs).all()):
        raise AssertionError(f"{cfg.name}: posterior cloud is not finite of "
                             f"shape ({n}, {d})")
    ok, est, sd = cfg.gate(mean, cov)
    if not ok:
        raise AssertionError(f"{cfg.name}: accuracy gate failed: est={est} "
                             f"sd={sd} truth={cfg.truth}")
    return seconds, est.tolist(), sd.tolist(), updater.resample_count, updater


def phase_configs(device):
    """Each config path: a warm-up window, then three timed windows with
    every counter set to 0 just before them and read just after."""
    launches = {}
    for make in CONFIGS:
        cfg = make()
        n_upd = len(cfg.outcomes)
        _config_window(cfg, 10_000, device)  # warm-up
        b1.fused_bayes_update.launches = 0
        b2.expand_sorted_segments.launches = 0
        qt.LiuWestResampler.redraw_rounds = 0
        windows = [_config_window(cfg, 1000 * (w + 1), device)
                   for w in range(3)]
        counts = {"B1": b1.fused_bayes_update.launches,
                  "B2": b2.expand_sorted_segments.launches}
        rounds = qt.LiuWestResampler.redraw_rounds
        n_resamples = [w[3] for w in windows]
        if counts["B1"] != 3 * n_upd:
            raise AssertionError(f"{cfg.name}: B1 launched {counts['B1']} "
                                 f"times, expected one per update "
                                 f"({3 * n_upd})")
        if sum(n_resamples) == 0 or counts["B2"] < sum(n_resamples):
            raise AssertionError(f"{cfg.name}: B2 launched {counts['B2']} "
                                 f"times for {sum(n_resamples)} resamples")
        secs = [w[0] for w in windows]
        print(json.dumps({"config": cfg.name, "n_particles": N_FLAGSHIP,
                          "n_updates": n_upd,
                          "particle_updates_per_s":
                              N_FLAGSHIP * n_upd / statistics.median(secs),
                          "window_s": secs, "n_resamples": n_resamples,
                          "redraw_rounds": rounds,
                          "redraw_rounds_per_resample":
                              rounds / sum(n_resamples),
                          "est": [w[1] for w in windows],
                          "sd": [w[2] for w in windows],
                          "launches": counts}))
        launches[cfg.name] = counts
    return launches


def _reset_counters():
    b1.fused_bayes_update.launches = 0
    b2.expand_sorted_segments.launches = 0
    b1.fused_bayes_update_batched.launches = 0
    b2.expand_sorted_segments_batched.launches = 0
    qt.LiuWestResampler.redraw_rounds = 0


def _read_counters():
    return ({"B1": b1.fused_bayes_update.launches,
             "B2": b2.expand_sorted_segments.launches},
            qt.LiuWestResampler.redraw_rounds)


def _check_launches(name, counts, n_updates, n_resamples):
    if counts["B1"] != n_updates:
        raise AssertionError(f"{name}: B1 launched {counts['B1']} times, "
                             f"expected one per update ({n_updates})")
    if n_resamples == 0 or counts["B2"] < n_resamples:
        raise AssertionError(f"{name}: B2 launched {counts['B2']} times for "
                             f"{n_resamples} resamples")


def phase_config5(device):
    """BASELINE config 5 at 2^20: a warm-up window, then three timed
    windows with every counter set to 0 just before them and read just
    after."""
    name = "config5_adaptive_tomography"
    warm = config5_window(config5_updater(N_FLAGSHIP, CONFIG5_SEEDS[0],
                                          device), CONFIG5_SEEDS[0])
    _reset_counters()
    windows = [config5_window(config5_updater(N_FLAGSHIP, s, device), s)
               for s in CONFIG5_SEEDS[1:]]
    counts, rounds = _read_counters()
    gates = [config5_gate(w) for w in [warm] + windows]
    print(json.dumps({"config5_gates": [
        {"seed": s, "ok": ok, "err": err, "spread": spread}
        for s, (ok, err, spread) in zip(CONFIG5_SEEDS, gates)]}))
    if not all(g[0] for g in gates):
        raise AssertionError(f"{name}: a window failed its gate "
                             f"(‖x̂ − x‖ < {Z_1Q}·√tr Σ̂, √tr Σ̂ < "
                             f"{SPREAD_1Q}, x̂ physical, IG finite)")
    n_resamples = [w["updater"].resample_count for w in windows]
    _check_launches(name, counts, 3 * N_STEPS_1Q, sum(n_resamples))
    secs = [w["seconds"] for w in windows]
    med = statistics.median(secs)
    print(json.dumps({
        "config": name, "n_particles": N_FLAGSHIP, "n_updates": N_STEPS_1Q,
        "particle_updates_per_s": N_FLAGSHIP * N_STEPS_1Q / med,
        "window_s": secs,
        "eig_ms_per_step": [w["eig_ms_per_step"] for w in windows],
        "update_ms_per_step": [w["update_ms_per_step"] for w in windows],
        "n_resamples": n_resamples, "redraw_rounds": rounds,
        "redraw_rounds_per_resample": rounds / sum(n_resamples),
        "err": [g[1] for g in gates[1:]],
        "spread": [g[2] for g in gates[1:]],
        "est": [w["est"].tolist() for w in windows],
        "choices": [np.bincount(w["choices"], minlength=3).tolist()
                    for w in windows],
        "launches": counts}))
    return counts


def phase_tomography_2q(device):
    """Two-qubit binomial tomography at N_2Q, as the config paths."""
    name = "tomography_2q_binomial"
    tomography_2q_window(tomography_2q_updater(N_2Q, 10_000, device))
    _reset_counters()
    windows = [tomography_2q_window(tomography_2q_updater(
        N_2Q, 1000 * (w + 1), device)) for w in range(3)]
    counts, rounds = _read_counters()
    overlaps = []
    for w in windows:
        ok, overlap = tomography_2q_gate(w)
        if not ok:
            raise AssertionError(f"{name}: gate failed: Tr(ρ̂ρ) = {overlap}")
        overlaps.append(overlap)
    n_resamples = [w["updater"].resample_count for w in windows]
    _check_launches(name, counts, 3 * N_SETTINGS_2Q, sum(n_resamples))
    secs = [w["seconds"] for w in windows]
    print(json.dumps({
        "config": name, "n_particles": N_2Q, "n_updates": N_SETTINGS_2Q,
        "particle_updates_per_s":
            N_2Q * N_SETTINGS_2Q / statistics.median(secs),
        "window_s": secs, "n_resamples": n_resamples,
        "redraw_rounds": rounds,
        "redraw_rounds_per_resample": rounds / sum(n_resamples),
        "overlap": overlaps, "launches": counts}))
    return counts


# -- adaptive PGH loops (BASELINE config 1, config 4's known-T2) ----------------

N_PGH_STEPS = 100
# (name, model, true ω, gate slack): examples/config1_precession_quickstart.py
# :12-32 and examples/config4_multiparameter_hamiltonian.py:31-47.
PGH_PATHS = (
    ("config1_quickstart_pgh", qt.SimplePrecessionModel(), 0.512, 1e-3),
    ("config4_known_t2_pgh", qt.KnownT2PrecessionModel(t2=100.0), 0.44, 5e-3),
)


def pgh_window(model, truth, seed, device, n=N_FLAGSHIP, n_steps=N_PGH_STEPS,
               **updater_kw):
    """One adaptive window: ``n_steps`` of PGH → simulate_experiment at the
    true ω on the card → update, on a fresh updater with the uniform prior
    on [0, 1]. The simulator draws from its own generator (seed + 1).
    Returns the window's time, estimate, σ and resample count."""
    u = qt.SMCUpdater(model, n, qt.UniformDistribution([0, 1]),
                      zero_weight_policy="reset", seed=seed, device=device,
                      **updater_kw)
    heuristic = qt.PGH(u)
    sim = torch.Generator(device=device).manual_seed(seed + 1)
    true_mp = torch.tensor([[truth]], device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ep = heuristic()
        outcome = model.simulate_experiment(sim, true_mp, ep)[0, 0, 0]
        u.update(outcome, ep)
    est = float(u.est_mean()[0])  # forces the window to finish
    seconds = time.perf_counter() - t0
    sd = float(torch.sqrt(u.est_covariance_mtx()[0, 0]))
    return {"seconds": seconds, "est": est, "sd": sd,
            "resamples": u.resample_count,
            "finite": bool(torch.isfinite(u.particle_locations).all())}


def phase_pgh_paths(device):
    """Each PGH path at 2^20: a warm-up window, then three timed windows
    (seeds 1–3) with every counter set to 0 just before them and read just
    after; every window gated |est − ω| < 6σ + slack. One JSON line each."""
    launches = {}
    for name, model, truth, slack in PGH_PATHS:
        pgh_window(model, truth, 0, device)  # warm-up
        _reset_counters()
        windows = [pgh_window(model, truth, s, device) for s in (1, 2, 3)]
        counts, rounds = _read_counters()
        for w in windows:
            if not (w["finite"] and abs(w["est"] - truth)
                    < 6 * w["sd"] + slack):
                raise AssertionError(f"{name}: gate failed: est={w['est']} "
                                     f"sd={w['sd']} truth={truth}")
        n_resamples = [w["resamples"] for w in windows]
        _check_launches(name, counts, 3 * N_PGH_STEPS, sum(n_resamples))
        secs = [w["seconds"] for w in windows]
        print(json.dumps({
            "config": name, "n_particles": N_FLAGSHIP,
            "n_updates": N_PGH_STEPS,
            "particle_updates_per_s":
                N_FLAGSHIP * N_PGH_STEPS / statistics.median(secs),
            "window_s": secs, "est": [w["est"] for w in windows],
            "sd": [w["sd"] for w in windows], "truth": truth,
            "n_resamples": n_resamples, "redraw_rounds": rounds,
            "launches": counts}))
        launches[name] = counts
    return launches


# -- trial ensembles (perf_test_multiple) ---------------------------------------

# (name, T, N, n_exp): bench_ensemble.py:54-58.
ENSEMBLES = (("ensemble_small", 256, 2048, 100),
             ("ensemble_big", 4, 1 << 18, 50))
ENSEMBLE_SEEDS = (7, 8, 9)
ENSEMBLE_GATE = 1e-3  # median final loss, bench_ensemble.py:47


def ensemble_run(n_trials, n, n_exp, seed, device, model=None, prior=None,
                 **kw):
    """perf_test_multiple with PGH on ``model`` under ``prior`` (default:
    SimplePrecessionModel under a uniform prior on [0, 1]; its own warm-up
    first). Returns the timed run's seconds, the records and the number of
    timed steps in which a trial resampled."""
    perf, seconds = qt.perf_test_multiple(
        n_trials, model or qt.SimplePrecessionModel(), n,
        prior or qt.UniformDistribution([0, 1]), n_exp, qt.PGH, seed=seed,
        return_time=True, device=device, **kw)
    counts = perf["resample_count"]
    steps_resampled = int(np.sum(np.any(
        np.diff(np.concatenate([np.zeros((n_trials, 1), int), counts], 1),
                axis=1) > 0, axis=0)))
    return seconds, perf, steps_resampled


class B2Capture:
    """Within ``with``: keeps a copy of the inputs of every batched B2
    call that ``LiuWestResampler.batched`` makes (its launch count is the
    wrapper's own, untouched)."""

    def __enter__(self):
        self.calls = []
        self._wrapped = qt.resamplers.expand_sorted_segments_batched

        def spy(starts, values, n_out=None, scale=None, shift=None):
            dense = torch.contiguous_format
            self.calls.append((starts.clone(memory_format=dense),
                               values.clone(memory_format=dense), scale,
                               shift.clone()))
            return self._wrapped(starts, values, n_out=n_out, scale=scale,
                                 shift=shift)

        qt.resamplers.expand_sorted_segments_batched = spy
        return self

    def __exit__(self, *exc):
        qt.resamplers.expand_sorted_segments_batched = self._wrapped

    def median_call(self):
        """(starts, values, scale, shift) of the call with the median
        number of resampled trials."""
        calls = sorted(self.calls, key=lambda c: c[0].shape[0])
        return calls[len(calls) // 2]


def phase_ensembles(device):
    """Each ensemble regime: three runs (seeds 7–9), each with every
    counter set to 0 just before it and read just after; each gated on its
    median final loss. B1 batched must launch exactly once per step (the
    timed run's n_exp and the warm-up's), single-bank B1 never, B2 batched
    at least once per timed step that resampled. Then one more run of seed
    7 under ``B2Capture`` (so that its copies touch no timed run). Returns
    the launch counts and, per regime, the inputs of its median B2 call."""
    from qinfer_tpu_torch.perf_testing import _WARMUP_EXPERIMENTS

    out, b2_inputs = {}, {}
    for name, n_trials, n, n_exp in ENSEMBLES:
        runs, counts = [], None
        for seed in ENSEMBLE_SEEDS:
            _reset_counters()
            seconds, perf, steps_resampled = ensemble_run(n_trials, n, n_exp,
                                                          seed, device)
            run_counts = {"B1": b1.fused_bayes_update.launches,
                          "B1_batched": b1.fused_bayes_update_batched.launches,
                          "B2_batched":
                              b2.expand_sorted_segments_batched.launches}
            loss = float(np.median(perf["loss"][:, -1]))
            steps = n_exp + min(n_exp, _WARMUP_EXPERIMENTS)
            if not loss < ENSEMBLE_GATE or not np.all(
                    np.isfinite(perf["est"])):
                raise AssertionError(f"{name}: median final loss {loss}")
            if run_counts["B1_batched"] != steps or run_counts["B1"] != 0:
                raise AssertionError(f"{name}: B1 launches {run_counts}, "
                                     f"expected {steps} batched, 0 single")
            if (steps_resampled == 0
                    or run_counts["B2_batched"] < steps_resampled):
                raise AssertionError(f"{name}: B2 batched launched "
                                     f"{run_counts['B2_batched']} times for "
                                     f"{steps_resampled} resampling steps")
            runs.append({"seconds": seconds, "loss": loss,
                         "steps_resampled": steps_resampled,
                         "resamples": int(perf["resample_count"][:, -1].sum()),
                         "launches": run_counts})
            counts = {k: (counts or {}).get(k, 0) + v
                      for k, v in run_counts.items()}
        secs = [r["seconds"] for r in runs]
        print(json.dumps({
            "config": name, "n_trials": n_trials, "n_particles": n,
            "n_exp": n_exp,
            "ensemble_particle_updates_per_s":
                n_trials * n * n_exp / statistics.median(secs),
            "wall_s": secs,
            "ms_per_step": [1e3 * s / n_exp for s in secs],
            "median_final_loss": [r["loss"] for r in runs],
            "steps_resampled": [r["steps_resampled"] for r in runs],
            "resamples": [r["resamples"] for r in runs],
            "launches": counts}))
        out[name] = counts
        with B2Capture() as capture:
            ensemble_run(n_trials, n, n_exp, ENSEMBLE_SEEDS[0], device)
        b2_inputs[name] = capture.median_call()
    return out, b2_inputs


# -- the rest of the engine API (BCRB, divergence, mixed ALE, summaries) --------

ALE_THRESH = 0.9  # MixedApproximateSMCUpdater's mixture_thresh on mixed_ale
SAMPLE_N = 1 << 16
BCRB_RTOL = 1e-3


def bcrb_window(n, seed, device):
    """flagship_bcrb: ``SMCUpdaterBCRB`` (adaptive) on the flagship record,
    ``update`` per experiment. For the cos² likelihood every particle's
    Fisher information is t², so the BIM must be Σ t² but for the weight of
    particles whose score is zeroed at L ≤ 1e-10."""
    ts, outcomes = experiment_record(N_EXP, 0)
    u = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), n,
                          qt.UniformDistribution([0, 1]),
                          zero_weight_policy="reset", seed=seed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for t, outcome in zip(ts, outcomes):
        u.update(int(outcome), {"t": np.array([t], np.float32)})
    est = float(u.est_mean()[0])  # forces the window to finish
    seconds = time.perf_counter() - t0
    sum_t2 = float(np.sum(ts.astype(np.float64) ** 2))
    bim = float(u.current_bim[0, 0])
    return {"updater": u, "seconds": seconds, "est": est, "bim": bim,
            "sum_t2": sum_t2, "bim_ratio": bim / sum_t2,
            "var": float(u.est_covariance_mtx()[0, 0]),
            "bcrb": float(u.current_bcrb[0, 0]),
            "resamples": u.resample_count}


def bcrb_gate(w):
    """BIM = Σ t² within BCRB_RTOL, the accuracy gate, and the posterior
    variance above 0.1 · BCRB (tests/test_expdesign.py:62-63)."""
    return (abs(w["bim_ratio"] - 1.0) < BCRB_RTOL
            and abs(w["est"] - TRUE_OMEGA) < GATE
            and w["var"] > 0.1 * w["bcrb"])


def track_rsd_window(n, seed, device):
    """flagship_track_rsd: ``batch_update`` of the flagship record with
    ``track_resampling_divergence=True`` (the eager route, update by
    update, each resample's divergence computed on the host)."""
    ts, outcomes = experiment_record(N_EXP, 0)
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                      qt.UniformDistribution([0, 1]),
                      zero_weight_policy="reset",
                      track_resampling_divergence=True, seed=seed,
                      device=device)
    _sync(device)
    t0 = time.perf_counter()
    u.batch_update(outcomes, {"t": ts})
    est = float(u.est_mean()[0])
    return {"updater": u, "seconds": time.perf_counter() - t0, "est": est,
            "divergences": list(u.resampling_divergences),
            "resamples": u.resample_count}


def track_rsd_gate(w):
    """The accuracy gate; one divergence per resample, at least one; every
    divergence finite and ≥ −1e-9."""
    divs = np.asarray(w["divergences"])
    return (abs(w["est"] - TRUE_OMEGA) < GATE
            and len(divs) == w["resamples"] > 0
            and bool(np.all(np.isfinite(divs)) and np.all(divs >= -1e-9)))


def mixed_ale_window(n, seed, device):
    """mixed_ale: ``MixedApproximateSMCUpdater`` with the exact precession
    model and, while the posterior is broad, ``ALEApproximateModel`` over
    it, on the flagship record. Records, per update on the approximate
    model, its seconds and its draws per cell."""
    ts, outcomes = experiment_record(N_EXP, 0)
    good = qt.SimplePrecessionModel()
    approximate = qt.ALEApproximateModel(simulator=qt.SimplePrecessionModel())
    u = qt.MixedApproximateSMCUpdater(
        good, approximate, n, qt.UniformDistribution([0, 1]),
        mixture_thresh=ALE_THRESH, zero_weight_policy="reset", seed=seed,
        device=device)
    approx_s, approx_samples = [], []
    _sync(device)
    t0 = time.perf_counter()
    for t, outcome in zip(ts, outcomes):
        ta = time.perf_counter()
        u.update(int(outcome), {"t": np.array([t], np.float32)})
        if u.model is approximate:
            _sync(device)
            approx_s.append(time.perf_counter() - ta)
            approx_samples.append(approximate.last_n_samples)
    est = float(u.est_mean()[0])
    return {"updater": u, "seconds": time.perf_counter() - t0, "est": est,
            "sharpened": u._sharpened, "approx_updates": len(approx_s),
            "approx_s": approx_s, "approx_samples": approx_samples,
            "resamples": u.resample_count}


def mixed_ale_gate(w):
    """Switched to the exact model, and the accuracy gate at the end."""
    return w["sharpened"] and abs(w["est"] - TRUE_OMEGA) < GATE


def host_credible_size(weights, level=0.95, dtype=np.float64):
    """The credible set's size recomputed on the host: a stable descending
    sort of the f32 weights and NumPy's cumulative sum in ``dtype``."""
    w = np.asarray(weights, np.float32)
    order = np.argsort(-w, kind="stable")
    return int(np.searchsorted(np.cumsum(w[order], dtype=dtype), level) + 1)


def posterior_summaries(u, truth, device):
    """Each posterior summary on updater ``u``'s bank, timed (host clock
    around a sync), with its gate values: the credible set's size and its
    host recomputation, the truth in the 0.99 hpd-hull region, the
    marginal's integral, the mesh finite, and the sample mean's distance
    from ``est_mean`` in standard errors."""
    truth = np.asarray([truth], np.float64)
    out, seconds = {}, {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        result = fn()
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        return result

    region = timed("est_credible_region",
                   lambda: u.est_credible_region(0.95))
    out["credible_size"] = int(region.shape[0])
    weights = u.particle_weights.cpu().numpy()
    out["host_credible_size"] = host_credible_size(weights)
    out["host_credible_size_f32"] = host_credible_size(weights,
                                                       dtype=np.float32)
    vertices, _ = timed("region_est_hull", lambda: u.region_est_hull(0.95))
    out["hull_vertices"] = int(vertices.shape[0])
    A, c = timed("region_est_ellipsoid",
                 lambda: u.region_est_ellipsoid(0.95))
    out["ellipsoid_center"] = np.asarray(c).tolist()
    out["truth_in_hull"] = bool(timed("in_credible_region_hull",
                                      lambda: u.in_credible_region(
                                          truth, level=0.99))[0])
    out["truth_in_mvee"] = bool(np.all(timed(
        "in_credible_region_mvee", lambda: u.in_credible_region(
            truth, level=0.99, method="hpd-mvee"))))
    xs, hist = timed("posterior_marginal", lambda: u.posterior_marginal())
    x0 = u.particle_locations[:, 0]
    edges = np.histogram_bin_edges(np.zeros(0, np.float32), bins=len(xs),
                                   range=(float(x0.min()), float(x0.max())))
    out["marginal_integral"] = float(hist.cpu().numpy() @ np.diff(edges))
    _, _, z = timed("posterior_mesh",
                    lambda: u.posterior_mesh(res1=100, res2=100))
    out["mesh_finite"] = bool(torch.isfinite(z).all())
    out["mesh_shape"] = list(z.shape)
    draws = timed("sample", lambda: u.sample(n=SAMPLE_N))
    mean = u.est_mean().cpu().numpy().astype(np.float64)
    se = np.sqrt(np.diag(u.est_covariance_mtx().cpu().numpy()) / SAMPLE_N)
    draw_mean = draws.to(torch.float64).mean(0).cpu().numpy()
    out["sample_z"] = (np.abs(draw_mean - mean) / se).tolist()
    out["seconds"] = seconds
    return out


def summaries_gate(s):
    """Credible size within ±1 of the host f64 recomputation, the truth inside
    the 0.99 hpd-hull region, the marginal integrating to 1 within 1e-5,
    the mesh finite, the sample mean within 5 standard errors."""
    return (abs(s["credible_size"] - s["host_credible_size"]) <= 1
            and s["truth_in_hull"]
            and abs(s["marginal_integral"] - 1.0) < 1e-5
            and s["mesh_finite"] and max(s["sample_z"]) < 5.0)


def phase_engine_api(device):
    """The four engine-API paths at 2^20, each with every counter set to 0
    just before it and read just after, gated, one JSON line each: B1 once
    per update on the exact model, B2 at least once per resample. A small
    warm-up first takes the one-time costs out of the timed paths (forward
    AD's first use, about 2.5 s; scipy's first hull)."""
    launches = {}
    cfg = config4_multicos2()
    bcrb_window(1 << 12, 0, device)
    posterior_summaries(_config_window(cfg, 0, device, n=1 << 12)[4],
                        cfg.truth, device)

    def run(name, fn, gate, n_b1):
        _reset_counters()
        w = fn()
        counts, rounds = _read_counters()
        summary = {k: v for k, v in w.items() if k != "updater"}
        ok = gate(w)
        print(json.dumps({"path": name, "n_particles": N_FLAGSHIP,
                          "ok": ok, **summary, "redraw_rounds": rounds,
                          "launches": counts}))
        if not ok:
            raise AssertionError(f"{name}: gate failed")
        _check_launches(name, counts, n_b1(w), w["resamples"])
        launches[name] = counts
        return w

    run("flagship_bcrb", lambda: bcrb_window(N_FLAGSHIP, 1, device),
        bcrb_gate, lambda w: N_EXP)
    run("flagship_track_rsd", lambda: track_rsd_window(N_FLAGSHIP, 2, device),
        track_rsd_gate, lambda w: N_EXP)
    mixed = run("mixed_ale", lambda: mixed_ale_window(N_FLAGSHIP, 3, device),
                mixed_ale_gate, lambda w: N_EXP - w["approx_updates"])
    samples = mixed["approx_samples"]
    ale = qt.ALEApproximateModel()
    print(json.dumps({"mixed_ale_ale_calls": {
        "updates_on_ale": mixed["approx_updates"],
        "batches_per_call": [1 + (s - ale.min_samp) // ale.samp_step
                             for s in samples],
        "seconds_per_call": mixed["approx_s"]}}))

    def summaries():
        seconds, est, sd, resamples, u = _config_window(cfg, 4, device)
        s = posterior_summaries(u, cfg.truth, device)
        return {"updater": u, "window_s": seconds, "est": est, "sd": sd,
                "resamples": resamples, **s}

    run("posterior_summaries", summaries, summaries_gate,
        lambda w: len(cfg.outcomes))
    return launches


# -- the rest of the model zoo: random walks and vector outcomes ----------------

N_WALK_STEPS = 1000
WALK_T = np.pi / 2
WALK_SHOTS = 40
WALK_STD = 0.01  # the truth's step and the model's NormalDistribution(0, 1e-4)
N_DRIFT_STEPS = 400
DRIFT_STD = 0.005
DIE_P = (0.6, 0.3, 0.1)
DIE_SHOTS = 20
N_DIE = 100


def random_walk_record(seed=0, n_steps=N_WALK_STEPS):
    """random_walk_tracking's record: ω_0 = 0.5; datum k is a
    Binomial(40, sin²(ω_k·π/4)) count (the precession model's Pr(1) at
    t = π/2), then ω_{k+1} = clip(ω_k + N(0, 0.01²), 0, 1). Returns
    (ω_0 … ω_n, counts)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0.0, WALK_STD, n_steps)
    omega = np.empty(n_steps + 1)
    omega[0] = 0.5
    for k in range(n_steps):
        omega[k + 1] = np.clip(omega[k] + steps[k], 0.0, 1.0)
    counts = rng.binomial(WALK_SHOTS, np.sin(0.5 * WALK_T * omega[:-1]) ** 2)
    return omega, counts.astype(np.int32)


def random_walk_updater(n, seed, device, **kw):
    """``RandomWalkModel(BinomialModel(SimplePrecessionModel()),
    NormalDistribution(0, 1e-4))`` over a uniform prior on [0, 1]
    (``kw``: more ``SMCUpdater`` arguments)."""
    model = qt.RandomWalkModel(qt.BinomialModel(qt.SimplePrecessionModel()),
                               qt.NormalDistribution(0.0, WALK_STD ** 2))
    return qt.SMCUpdater(model, n, qt.UniformDistribution([0, 1]),
                         zero_weight_policy="reset", seed=seed, device=device,
                         **kw)


def random_walk_window(u, n_steps=N_WALK_STEPS):
    """n_steps of ``update`` on updater ``u`` (the walk's timestep after
    each), each step's ``est_mean`` kept on the device and read once at
    the end. The estimate after update k predicts ω_{k+1}, the truth of
    the next datum."""
    omega, counts = random_walk_record(n_steps=n_steps)
    ep = {"t": np.array([WALK_T], np.float32),
          "n_meas": np.array([WALK_SHOTS], np.int32)}
    ests = []
    _sync(u.device)
    t0 = time.perf_counter()
    for k in counts:
        u.update(int(k), ep)
        ests.append(u.est_mean()[0])
    ests = torch.stack(ests).cpu().numpy()  # forces the window to finish
    seconds = time.perf_counter() - t0
    return {"updater": u, "seconds": seconds, "est": ests, "truth": omega[1:],
            "sd": float(torch.sqrt(u.est_covariance_mtx()[0, 0])),
            "resamples": u.resample_count}


def random_walk_gate(w):
    """RMS(ω̂_k − ω_{k+1}) over the second half of the steps < 0.06 (a
    Kalman filter on this record gives ≈ 0.03: Fisher information 40·π²/4
    a datum, walk variance 1e-4 a step), and the final |ω̂ − ω| < 6σ̂ +
    0.02. Returns (ok, values)."""
    half = len(w["est"]) // 2
    rms = float(np.sqrt(np.mean((w["est"][half:] - w["truth"][half:]) ** 2)))
    err = float(abs(w["est"][-1] - w["truth"][-1]))
    ok = rms < 0.06 and err < 6 * w["sd"] + 0.02
    return ok, {"rms": rms, "final_err": err, "final_sd": w["sd"]}


def gaussian_walk_record(seed=0, n_steps=N_DRIFT_STEPS):
    """gaussian_walk_drift's record: ω_0 = 0.70710678 walking by
    N(0, 0.005²) a step; single shots at t = (9/8)^(k mod 20), outcome 1
    with probability sin²(ω_k t_k / 2). Returns (ω_0 … ω_n, ts,
    outcomes)."""
    rng = np.random.default_rng(seed)
    ts = ((9 / 8) ** (np.arange(n_steps) % 20)).astype(np.float32)
    omega = TRUE_OMEGA + np.concatenate(
        [[0.0], np.cumsum(rng.normal(0.0, DRIFT_STD, n_steps))])
    p0 = np.cos(0.5 * omega[:-1] * ts) ** 2
    return omega, ts, (rng.random(n_steps) >= p0).astype(np.int32)


def gaussian_walk_updater(n, seed, device, **kw):
    """``GaussianRandomWalkModel(SimplePrecessionModel(), diagonal=True)``
    over the prior of ``__graft_entry__.py:142-143``."""
    model = qt.GaussianRandomWalkModel(qt.SimplePrecessionModel(),
                                       diagonal=True)
    return qt.SMCUpdater(model, n,
                         qt.UniformDistribution([[0, 1], [0.001, 0.05]]),
                         zero_weight_policy="reset", seed=seed, device=device,
                         **kw)


def gaussian_walk_window(u):
    """One ``batch_update`` of the drift record on updater ``u``."""
    omega, ts, outcomes = gaussian_walk_record()
    _sync(u.device)
    t0 = time.perf_counter()
    u.batch_update(outcomes, {"t": ts})
    est = u.est_mean().cpu().numpy()  # forces the window to finish
    seconds = time.perf_counter() - t0
    return {"updater": u, "seconds": seconds, "est": est,
            "sd": np.sqrt(np.diag(u.est_covariance_mtx().cpu().numpy())),
            "truth": omega[-1],
            "finite": bool(torch.isfinite(u.particle_locations).all()),
            "resamples": u.resample_count}


def gaussian_walk_gate(w):
    """Final |ω̂ − ω| < 6σ̂ + 0.02, the posterior mean of sigma_omega
    finite in [0, 0.05], no NaN in the bank. Returns (ok, values)."""
    err = float(abs(w["est"][0] - w["truth"]))
    sigma = float(w["est"][1])
    ok = (w["finite"] and err < 6 * w["sd"][0] + 0.02
          and 0.0 <= sigma <= 0.05)
    return ok, {"final_err": err, "final_sd": float(w["sd"][0]),
                "sigma_omega": sigma}


def die_record(seed=0):
    """multinomial_die's record: 100 count vectors of 20 throws of a die
    with face probabilities (0.6, 0.3, 0.1)."""
    rng = np.random.default_rng(seed)
    return rng.multinomial(DIE_SHOTS, DIE_P, size=N_DIE).astype(np.int32)


def die_updater(n, seed, device, **kw):
    """``MultinomialModel(NDieModel(n=3))`` over a uniform prior rescaled
    to the simplex (tests/test_round2_fixes.py:13-45)."""
    prior = qt.ConstrainedSumDistribution(
        qt.UniformDistribution([[0.0, 1.0]] * 3), desired_total=1.0)
    return qt.SMCUpdater(qt.MultinomialModel(qt.NDieModel(n=3)), n, prior,
                         zero_weight_policy="reset", seed=seed, device=device,
                         **kw)


def die_window(u):
    """One ``batch_update`` of the (100, 3) count vectors on updater
    ``u``."""
    counts = die_record()
    ep = {"exp_num": np.zeros(N_DIE, np.int32),
          "n_meas": np.full(N_DIE, DIE_SHOTS, np.int32)}
    _sync(u.device)
    t0 = time.perf_counter()
    u.batch_update(counts, ep)
    est = u.est_mean().cpu().numpy()  # forces the window to finish
    seconds = time.perf_counter() - t0
    return {"updater": u, "seconds": seconds, "est": est,
            "sd": np.sqrt(np.diag(u.est_covariance_mtx().cpu().numpy())),
            "n_records": len(u.normalization_record),
            "resamples": u.resample_count}


def die_gate(w):
    """|p̂_i − p_i| < 6σ̂_i + 0.01 on each face, |Σ p̂ − 1| < 1e-3, one
    normalization record per count vector. Returns (ok, values)."""
    err = np.abs(w["est"] - np.asarray(DIE_P))
    total = float(np.sum(w["est"]))
    ok = (bool(np.all(err < 6 * w["sd"] + 0.01)) and abs(total - 1.0) < 1e-3
          and w["n_records"] == N_DIE)
    return ok, {"est": w["est"].tolist(), "sd": w["sd"].tolist(),
                "sum": total, "n_records": w["n_records"]}


ZOO_PATHS = (
    ("random_walk_tracking", random_walk_updater, random_walk_window,
     random_walk_gate),
    ("gaussian_walk_drift", gaussian_walk_updater, gaussian_walk_window,
     gaussian_walk_gate),
    ("multinomial_die", die_updater, die_window, die_gate),
)


def phase_model_zoo(device):
    """The three model-zoo paths at 2^20 (``ZOO_PATHS``): for each, a
    warm-up window, then three timed windows with every counter set to 0
    just before them and read just after. Every window is gated; B1 must
    not launch (no model here has a tile: the step updates them unfused),
    B2 at least once per resample. One JSON line each."""
    launches = {}
    for name, make, window, gate in ZOO_PATHS:
        warm = gate(window(make(N_FLAGSHIP, 10_000, device)))
        _reset_counters()
        windows = [window(make(N_FLAGSHIP, 1000 * (i + 1), device))
                   for i in range(3)]
        counts, rounds = _read_counters()
        gates = [warm] + [gate(w) for w in windows]
        resamples = [w["resamples"] for w in windows]
        ms = [1e3 * w["seconds"] for w in windows]
        print(json.dumps({
            "path": name, "n_particles": N_FLAGSHIP,
            "ok": [g[0] for g in gates],
            "window_ms_median": statistics.median(ms),
            "window_ms_range": [min(ms), max(ms)], "window_ms": ms,
            "resamples": resamples, "redraw_rounds": rounds,
            "redraw_rounds_per_resample": rounds / max(1, sum(resamples)),
            "gate_values": [g[1] for g in gates], "launches": counts}))
        if not all(g[0] for g in gates):
            raise AssertionError(f"{name}: gate failed")
        if counts["B1"] != 0:
            raise AssertionError(f"{name}: B1 launched {counts['B1']} times; "
                                 "these models have no tile")
        if sum(resamples) == 0 or counts["B2"] < sum(resamples):
            raise AssertionError(f"{name}: B2 launched {counts['B2']} times "
                                 f"for {sum(resamples)} resamples")
        launches[name] = counts
    return launches



# -- the distributed layer (qinfer_tpu_torch.parallel) --------------------------

SHARD_KS = (2, 4, 8)  # ranks whose windows the compare phase checks
SHARD_DS = (1, 4)


def shard_windows(log_w, k_shards, u0):
    """The starts of a bank split over ``k_shards`` ranks, as the sharded
    step's all-gather migration computes them on every rank (one bank's
    ``systematic_segment_starts``), and each rank's window of them: the
    starts shifted by the window's origin k·n_local and clamped at 0, what
    its B2 launch takes. Returns (starts (N,), the K windows)."""
    n_local = log_w.shape[0] // k_shards
    starts = systematic_segment_starts(log_w, log_w.shape[0], u0=u0)
    return starts, [torch.clamp(starts - k * n_local, min=0)
                    for k in range(k_shards)]


def merge_lse(values):
    """``sharded_smc._merge_lse``'s arithmetic over the K ranks' values,
    in one process: the max, then the sum of exp(value − max)."""
    m = torch.amax(values)
    return m + torch.log(torch.sum(torch.exp(values - m)))


def phase_compare_sharded(device):
    """B2 on the K ranks' windows (K ∈ SHARD_KS, D ∈ SHARD_DS, the three
    weight kinds of ``_weights``, 2^20 rows): each window's launch, in the
    wrapper's form and in the rows form forced, bit-equal to its plain
    version, and the K windows' rows together bit-equal to the one-bank
    ``systematic_expand`` at the same u0. B1 per shard: ``return_stats``
    on K slices (precession and born4), merged as ``_merge_lse`` merges,
    within B1_TOL of the one-bank launch, the slices' raw lw bit-equal to
    the one-bank raw lw. Raises on any mismatch; returns the worst errors
    {"precession", "born4", "B2"}."""
    worst = {"precession": 0.0, "born4": 0.0, "B2": 0.0}
    rng = np.random.default_rng(5)
    n = N_FLAGSHIP
    for d in SHARD_DS:
        vals = torch.as_tensor(rng.standard_normal((n, d)),
                               dtype=torch.float32, device=device)
        shift = 0.02 * torch.as_tensor(rng.standard_normal(d),
                                       dtype=torch.float32, device=device)
        aff = b2._affine(0.98, shift, d, device)
        for kind in ("random", "degenerate", "single_heavy"):
            log_w = torch.as_tensor(_weights(kind, n, rng), device=device)
            one = b2.systematic_expand(log_w, vals, scale=0.98, shift=shift,
                                       u0=0.37)
            for k_shards in SHARD_KS:
                n_local = n // k_shards
                windows = shard_windows(log_w, k_shards, 0.37)[1]
                outs, same = [], True
                for shifted in windows:
                    out_k = b2.expand_sorted_segments(
                        shifted, vals, n_out=n_local, scale=0.98, shift=shift)
                    out_r = b2._expand_cuda_batched(
                        shifted[None], vals[None], n_local, aff[None],
                        form=b2.ROWS)[0]
                    out_p = b2.expand_plain(shifted, vals, n_local, aff)
                    same &= torch.equal(out_k, out_p) and torch.equal(out_r,
                                                                      out_p)
                    worst["B2"] = max(worst["B2"], float(
                        torch.max(torch.abs(out_k - out_p))))
                    outs.append(out_k)
                whole = torch.equal(torch.cat(outs), one)
                print(f"B2 sharded K={k_shards} D={d} {kind}: windows "
                      f"(form {b2.kernel_form(d, n + n_local)} and rows) "
                      f"{'bit-equal' if same else 'DIFFER'} to plain, "
                      f"together {'bit-equal' if whole else 'DIFFERENT'} "
                      f"to one bank")
                if not (same and whole):
                    raise AssertionError(f"B2 on a shard window differs: "
                                         f"K={k_shards} D={d} {kind}")
    omega, lw = _b1_inputs(n, 11, device)
    cases = {"precession": (b1.two_outcome_tile(b1.precession_pr1),
                            torch.tensor([1.0, 17.3], device=device), lw,
                            (omega,)),
             "born4": tomo_inputs(TOMO[0], n, 11, device)}
    for name, (tile, scal, lw, cols) in cases.items():
        lw_1, ln_1, ess_1 = b1.fused_bayes_update(tile, scal, lw, cols)
        raw_1 = b1.fused_bayes_update(tile, scal, lw, cols,
                                      return_stats=True)[0]
        for k_shards in SHARD_KS:
            blocks = [slice(k * (n // k_shards), (k + 1) * (n // k_shards))
                      for k in range(k_shards)]
            parts = [b1.fused_bayes_update(tile, scal, lw[b],
                                           tuple(c[b] for c in cols),
                                           return_stats=True)
                     for b in blocks]
            raw = torch.cat([p[0] for p in parts])
            log_norm = merge_lse(torch.stack([p[1] for p in parts]))
            lse2 = merge_lse(torch.stack([p[2] for p in parts]))
            ess = torch.exp(-(lse2 - 2.0 * log_norm))
            torch.cuda.synchronize()
            err = float(torch.max(torch.abs((raw - log_norm) - lw_1)))
            ln_err = abs(float(log_norm) - float(ln_1))
            ess_rel = abs(float(ess) / float(ess_1) - 1.0)
            raw_same = torch.equal(raw, raw_1)
            ok = (err <= B1_TOL["lw_atol"] and ln_err <= B1_TOL["log_norm_atol"]
                  and ess_rel <= B1_TOL["ess_rtol"] and raw_same)
            print(f"B1 {name} sharded K={k_shards}: max|dlw|={err:.3g} "
                  f"|dlog_norm|={ln_err:.3g} ess_rel={ess_rel:.3g}, raw lw "
                  f"{'bit-equal' if raw_same else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"B1's merged shard statistics disagree "
                                     f"with one bank: {name} K={k_shards}")
            worst[name] = max(worst[name], err, ln_err)
    return worst


N_SHARDED_EPISODE_SEEDS = (0, 1, 2, 3)  # the warm-up window's, then three


def _sharded_setup(config, resampler):
    """The sharded paths' config and resampler unless given."""
    return (qt.SMCConfig(zero_weight_policy="reset") if config is None
            else config,
            qt.LiuWestResampler(a=0.98) if resampler is None else resampler)


def sharded_flagship_window(mesh, migration, seed, record_seed, device,
                            config=None, resampler=None):
    """The flagship record (``experiment_record``) through
    ``make_sharded_update_step`` on this rank's block of a 2^20 bank
    (``config`` and ``resampler`` replace the path's when given)."""
    model = qt.SimplePrecessionModel()
    config, resampler = _sharded_setup(config, resampler)
    step = par.make_sharded_update_step(mesh, model, resampler, config,
                                        migration=migration)
    group = mesh.get_group(par.PARTICLE_AXIS)
    ts, outcomes = experiment_record(N_EXP, record_seed)
    g = torch.Generator(device=device).manual_seed(seed)
    state = par.shard_state(qt.init_smc_state(
        g, model, N_FLAGSHIP, qt.UniformDistribution([0, 1])), mesh)
    ts = torch.as_tensor(ts, device=device)
    outcomes = torch.as_tensor(outcomes, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(N_EXP):
        state, _ = step(state, outcomes[i], {"t": ts[i:i + 1]})
    mu = sharded_smc.sharded_moments(state.particle_log_weights,
                                     state.particle_locations, group)[0]
    est = float(mu[0])  # forces the window to finish
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(state.particle_locations).all())
    return {"seconds": seconds, "est": est,
            "resamples": int(state.n_resamples),
            "ok": finite and abs(est - TRUE_OMEGA) < GATE,
            "gate": {"est": est, "finite": finite}}


def sharded_episode_window(mesh, kind, seed, device, config=None,
                           resampler=None):
    """One window of ``make_sharded_adaptive_episode`` on a 2^20 bank:
    ``kind`` "pgh" is config 1's loop (PGH, ω = 0.512, 100 steps, gate
    |est − ω| < 6σ + 1e-3), "eig" config 5's (greedy EIG over the three
    effects, 80 steps, the config-5 gate). The simulator draws from a
    replicated generator seeded ``seed + 1``. ``config`` and
    ``resampler`` replace the path's when given."""
    group = mesh.get_group(par.PARTICLE_AXIS)
    config, resampler = _sharded_setup(config, resampler)
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "pgh":
        model, truth, n_steps = qt.SimplePrecessionModel(), [[0.512]], 100
        prior = qt.UniformDistribution([0, 1])
        propose = par.make_sharded_pgh_propose(mesh)
    else:
        model, truth = tomo.TomographyModel(PAULI1), TRUE_X_1Q
        n_steps, prior = N_STEPS_1Q, tomo.GinibreDistribution(PAULI1)
        propose = par.make_sharded_greedy_propose(
            mesh, model, {"meas": EFFECTS_1Q})
    episode = par.make_sharded_adaptive_episode(
        mesh, model, resampler, config, propose, truth, n_steps)
    state = par.shard_state(qt.init_smc_state(g, model, N_FLAGSHIP, prior),
                            mesh)
    sim = torch.Generator(device=device).manual_seed(seed + 1)
    _sync(device)
    t0 = time.perf_counter()
    state, rec = episode(state, sim)
    mu, cov = sharded_smc.sharded_moments(state.particle_log_weights,
                                          state.particle_locations, group)
    mean, cov = mu.cpu().numpy(), cov.cpu().numpy()  # forces the window
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(state.particle_locations).all())
    shapes = (tuple(rec["log_norm"].shape) == (n_steps,)
              and tuple(rec["est_mean"].shape) == (n_steps, len(mean)))
    if kind == "pgh":
        sd = float(np.sqrt(cov[0, 0]))
        err = abs(float(mean[0]) - 0.512)
        ok = finite and shapes and err < 6 * sd + 1e-3
        gate = {"est": float(mean[0]), "sd": sd}
    else:
        spread = float(np.sqrt(np.trace(cov)))
        err = float(np.linalg.norm(mean - TRUE_X_1Q))
        physical = bool(model.are_models_valid(torch.as_tensor(
            mean[None]))[0])
        ig = par.make_sharded_expdesign(mesh, model)[1](
            state, {"meas": torch.as_tensor(EFFECTS_1Q, device=device)})
        igs = bool(ig.shape == (3,) and torch.isfinite(ig).all())
        ok = (finite and shapes and physical and igs
              and err < Z_1Q * spread and spread < SPREAD_1Q)
        meas = rec["expparams"]["meas"].cpu().numpy()
        chosen = np.argmin(np.abs(meas[:, None] - EFFECTS_1Q[None]).sum(-1),
                           axis=1)
        gate = {"err": err, "spread": spread, "physical": physical,
                "final_ig": ig.tolist(),
                "choices": np.bincount(chosen, minlength=3).tolist()}
    return {"seconds": seconds, "resamples": int(state.n_resamples),
            "ok": ok, "gate": gate}


def _sharded_path(name, window, n_windows, n_updates, smi, warm_up=True,
                  ring=False):
    """One sharded path: a warm-up window (``window(0)``) unless told
    otherwise, then ``n_windows`` timed windows (``window(1)``, …) with
    every counter set to 0 just before them and read just after. Every
    window is gated; B1 must launch once per update, B2 at least once per
    resample (never on the ring). One JSON line; returns the counts."""
    warm = [window(0)] if warm_up else []
    _reset_counters()
    windows = [window(i + 1) for i in range(n_windows)]
    counts, rounds = _read_counters()
    ms = [1e3 * w["seconds"] for w in windows]
    resamples = [w["resamples"] for w in windows]
    print(json.dumps({
        "path": name, "n_particles": N_FLAGSHIP, "world_size": 1,
        "card": smi, "ok": [w["ok"] for w in warm + windows],
        "window_ms_median": statistics.median(ms),
        "window_ms_range": [min(ms), max(ms)], "window_ms": ms,
        "particle_updates_per_s":
            N_FLAGSHIP * n_updates / statistics.median(ms) * 1e3,
        "resamples": resamples, "redraw_rounds": rounds,
        "gate_values": [w["gate"] for w in warm + windows],
        "launches": counts}))
    if not all(w["ok"] for w in warm + windows):
        raise AssertionError(f"{name}: gate failed")
    if counts["B1"] != n_updates * n_windows:
        raise AssertionError(f"{name}: B1 launched {counts['B1']} times, "
                             f"expected one per update "
                             f"({n_updates * n_windows})")
    if ring and counts["B2"] != 0:
        raise AssertionError(f"{name}: B2 launched {counts['B2']} times on "
                             "the ring, which never takes it")
    if not ring and (sum(resamples) == 0 or counts["B2"] < sum(resamples)):
        raise AssertionError(f"{name}: B2 launched {counts['B2']} times for "
                             f"{sum(resamples)} resamples")
    return counts


def phase_sharded(device, smi):
    """The sharded paths at 2^20 on an NCCL process group of one rank
    (a file store in a temporary directory), destroyed at the end whatever
    happens: ``sharded_flagship`` (all-gather migration: a warm-up and
    three gated windows), ``sharded_flagship_ring`` (one window, ring
    migration), ``sharded_config1_pgh`` and ``sharded_config5_eig``
    (``make_sharded_adaptive_episode``: a warm-up and three windows each).
    Returns the launch counts by path."""
    with nccl_world_one(device) as mesh:

        def flagship(migration):
            return lambda i: sharded_flagship_window(
                mesh, migration, 1000 * i if i else 10_000, max(i - 1, 0),
                device)

        def episode(kind):
            return lambda i: sharded_episode_window(
                mesh, kind, N_SHARDED_EPISODE_SEEDS[i], device)

        return {
            "sharded_flagship": _sharded_path(
                "sharded_flagship", flagship("all_gather"), 3, N_EXP, smi),
            "sharded_flagship_ring": _sharded_path(
                "sharded_flagship_ring", flagship("ring"), 1, N_EXP, smi,
                warm_up=False, ring=True),
            "sharded_config1_pgh": _sharded_path(
                "sharded_config1_pgh", episode("pgh"), 3, N_PGH_STEPS, smi),
            "sharded_config5_eig": _sharded_path(
                "sharded_config5_eig", episode("eig"), 3, N_STEPS_1Q, smi),
        }


@contextlib.contextmanager
def nccl_world_one(device):
    """An NCCL process group of one rank on ``device`` (a file store in a
    temporary directory), destroyed on exit whatever happens; yields the
    particle mesh."""
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            yield par.make_particle_mesh()
        finally:
            dist.destroy_process_group()


_STATE_ARRAYS = ("particle_locations", "particle_log_weights", "n_resamples",
                 "min_n_ess", "log_total_likelihood", "n_zero_weight_events")


def phase_aux(device):
    """The auxiliary modules on the card: ``ThroughputMeter``, ``trace``
    and ``annotate`` around one flagship window (the trace written, non-
    empty, holding the annotation), and a CUDA updater stopped half-way
    through the flagship record, written by ``save_npz``, read by
    ``load_npz`` into another updater and run on: its state bit-equal to
    the uninterrupted run's, resamples after the load included. One JSON
    line."""
    from qinfer_tpu_torch import checkpointing, profiling

    ts, outcomes = experiment_record(N_EXP, 0)
    half = N_EXP // 2

    def updater(seed):
        return qt.SMCUpdater(qt.SimplePrecessionModel(), N_FLAGSHIP,
                             qt.UniformDistribution([0, 1]),
                             zero_weight_policy="reset", seed=seed,
                             device=device)

    meter = profiling.ThroughputMeter()
    u = updater(21)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with meter.measure(N_FLAGSHIP * N_EXP,
                               sync=u.particle_log_weights):
                with profiling.annotate("flagship_window"):
                    u.batch_update(outcomes, {"t": ts})
        trace_file = os.path.join(tmp, "trace.json")
        size = os.path.getsize(trace_file)
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
        a = updater(22)
        a.batch_update(outcomes[:half], {"t": ts[:half]})
        at_save = a.resample_count
        checkpointing.save_npz(os.path.join(tmp, "ckpt.npz"), a)
        b = checkpointing.load_npz(os.path.join(tmp, "ckpt.npz"), updater(23))
    for x in (a, b):
        x.batch_update(outcomes[half:], {"t": ts[half:]})
    same = all(torch.equal(getattr(a.state, f), getattr(b.state, f))
               for f in _STATE_ARRAYS)
    est = float(u.est_mean()[0])
    annotated = any(e.get("name") == "flagship_window" for e in events)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    ok = (size > 0 and annotated and abs(est - TRUE_OMEGA) < GATE and same
          and a.resample_count > at_save)
    print(json.dumps({"aux": {
        "ok": ok, "meter": meter.report(), "trace_bytes": size,
        "trace_annotated": annotated, "trace_kernel_events": kernels,
        "est": est, "resume_bit_equal": same,
        "resamples_after_load": a.resample_count - at_save}}))
    if not ok:
        raise AssertionError("an auxiliary module failed on the card")


SAMPLER_N = 1 << 20
SAMPLER_Z = 5.0


def _z(x, mean, var):
    """|mean(x) − mean| per column of x (n, k) in standard errors √(var/n),
    in f64."""
    x = x.double().reshape(x.shape[0], -1)
    mean = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    var = torch.as_tensor(var, dtype=torch.float64, device=x.device)
    return ((x.mean(0) - mean) / torch.sqrt(var / x.shape[0])).abs().tolist()


def phase_samplers(device):
    """The port's samplers whose CUDA draws loop per element (binomial,
    Poisson, Gamma), on the card at 2^20 draws from one generator, each
    mean within SAMPLER_Z standard errors of its exact value: the
    multinomial ladder (two binomial calls), Beta (two Gamma calls),
    BetaBinomial, two Poisson calls in a row, and the correlation of two
    binomial calls in a row (|r| < SAMPLER_Z/√n). Printed beside them and
    not gated: the same ladder and pair by raw ``torch.binomial`` calls,
    without ``utils``' skip-ahead, and one raw call alone."""
    g = torch.Generator(device=device).manual_seed(0)
    n = SAMPLER_N
    p = torch.tensor([0.6, 0.3, 0.1], dtype=torch.float64, device=device)
    ladder_var = 20 * p * (1 - p)
    twenty = torch.full((n,), 20.0, device=device)
    z = {"multinomial": _z(qt.utils.sample_multinomial(
             g, torch.tensor(20.0), p.float(), (n,)), 20 * p, ladder_var),
         "beta": _z(qt.BetaDistribution(2.0, 5.0).sample(g, n), 2 / 7,
                    10 / (49 * 8)),
         "beta_binomial": _z(qt.BetaBinomialDistribution(12, 2.0, 3.0)
                             .sample(g, n), 4.8, 12 * 6 * 17 / (25 * 6)),
         "poisson": [_z(qt.utils.poisson(torch.full((n,), 7.5, device=device),
                                         g), 7.5, 7.5)[0] for _ in range(2)]}
    pair = [qt.utils.binomial(twenty, torch.full_like(twenty, 0.4), g)
            for _ in range(2)]
    corr = float(torch.corrcoef(torch.stack(pair))[0, 1])
    d1 = torch.binomial(twenty, torch.full_like(twenty, 0.6), generator=g)
    d2 = torch.binomial(twenty - d1, torch.full_like(twenty, 0.75),
                        generator=g)
    raw_pair = [torch.binomial(twenty, torch.full_like(twenty, 0.4),
                               generator=g) for _ in range(2)]
    eight = torch.full((n,), 8.0, device=device)
    raw = {"ladder": _z(torch.stack([d1, d2, twenty - d1 - d2], 1), 20 * p,
                        ladder_var),
           "pair_corr": float(torch.corrcoef(torch.stack(raw_pair))[0, 1]),
           "single_b8_025": _z(torch.binomial(
               eight, torch.full_like(eight, 0.25), generator=g), 2.0,
               1.5)[0]}
    worst = max(max(v) if isinstance(v, list) else v for v in z.values())
    ok = bool(worst < SAMPLER_Z and abs(corr) < SAMPLER_Z / np.sqrt(n))
    print(json.dumps({"samplers": {"n": n, "ok": ok, "z": z,
                                   "pair_corr": corr, "raw_torch": raw}}))
    if not ok:
        raise AssertionError("a sampler's draws on the card are off their "
                             "moments or correlated across calls")


# -- a user's own model on the card (B1 on the model's own pr1) ------------------

# (name, T, N, n_exp): perf_test_multiple on the user model at
# ensemble_small's shape.
USER_ENSEMBLE = ("user_tile_ensemble", 256, 2048, 100)


def _reset_route_counters():
    for wrapper in (b1.fused_bayes_update, b1.fused_bayes_update_batched):
        wrapper.user_launches = wrapper.column_launches = 0


def _route_counters():
    return {"B1_user": b1.fused_bayes_update.user_launches,
            "B1_column": b1.fused_bayes_update.column_launches,
            "B1_batched_user": b1.fused_bayes_update_batched.user_launches,
            "B1_batched_column":
                b1.fused_bayes_update_batched.column_launches}


def phase_compare_user(device):
    """The user tile on the card, from the library built of its source:
    two-outcome and binomial against their plain versions (and one launch
    bit-equal to two passes) at n ∈ {1000, 2^20 + 3, 2^20}; the column
    route (the torch-only twin, B1 on GivenPr1) against the user tile at
    the same inputs within B1_TOL, its GivenPr1 forms bit-equal; the trial
    grid at B1_BATCH_SHAPES within B1_TOL of its plain version and bit-equal
    per trial to single-bank launches, and its column route within B1_TOL
    of it. Returns the worst error of each."""
    worst = {}
    for binomial in (False, True):
        name = "binomial" if binomial else "two_outcome"
        worst[name] = worst[f"column_{name}"] = 0.0
        for n in (1000, N_FLAGSHIP + 3, N_FLAGSHIP):
            tile, scal, lw, cols = user_inputs(binomial, n, n, device)
            worst[name] = max(worst[name], _b1_check(
                f"user {name} n={n}", tile, scal, lw, cols))
            twin = type(tile)(LOST_VISIBILITY_TORCH)
            given, scal_g, cols_g, _ = b1._route(twin, scal, cols, lw.shape,
                                                 batched=False)
            _forms_check(f"GivenPr1 {name} n={n}", given, scal_g[None],
                         lw[None], tuple(c[None] for c in cols_g))
            worst[f"column_{name}"] = max(worst[f"column_{name}"], _agree(
                f"column route vs user {name} n={n}",
                b1.fused_bayes_update(twin, scal, lw, cols),
                b1.fused_bayes_update(tile, scal, lw, cols)))
    worst["batched"] = max(
        _b1_batched_check(f"user T={t} N={n}",
                          *user_batched_inputs(t, n, t + n, device))
        for t, n in B1_BATCH_SHAPES)
    tile, scal, lw, cols = user_batched_inputs(*B1_BATCH_SHAPES[0], 5, device)
    twin = type(tile)(LOST_VISIBILITY_TORCH)
    worst["column_batched"] = _agree(
        "column route vs user, trial grid",
        b1.fused_bayes_update_batched(twin, scal, lw, cols),
        b1.fused_bayes_update_batched(tile, scal, lw, cols))
    return worst


def _check_routes(name, counts, expected):
    """The route counters of a run: ``expected`` of each named one, 0 of
    the others."""
    want = {k: expected.get(k, 0) for k in _route_counters()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: B1 routes {got}, expected {want}")


def phase_user_tile(device):
    """The user model's paths at 2^20 (``USER_PATHS``): a warm-up window
    and three timed ones each, every counter set to 0 just before them and
    read just after, every window gated (``user_window``); B1 once an
    update on the user library (``user_tile``, ``user_tile_binomial``) or
    on the column route (``user_tile_column``), B2 at least once a
    resample. Then ``USER_ENSEMBLE`` (``perf_test_multiple`` with PGH, three
    runs, seeds 7–9), gated on the median final loss falling tenfold from
    the first experiment's (as ``tests/test_torch_ensemble.py``), the
    batched B1 once a step on the user library. One JSON line each;
    returns the launch counts."""
    from qinfer_tpu_torch.perf_testing import _WARMUP_EXPERIMENTS

    out = {}
    for name, model, record, n_meas in USER_PATHS:
        n_upd = len(user_records()[record][0])
        user_window(model, record, n_meas, N_FLAGSHIP, 10_000, device)
        _reset_counters()
        _reset_route_counters()
        windows = [user_window(model, record, n_meas, N_FLAGSHIP,
                               1000 * (w + 1), device) for w in range(3)]
        counts = {**_read_counters()[0], **_route_counters()}
        n_resamples = [w[3] for w in windows]
        _check_launches(name, counts, 3 * n_upd, sum(n_resamples))
        route = "B1_column" if name.endswith("_column") else "B1_user"
        _check_routes(name, counts, {route: 3 * n_upd})
        secs = [w[0] for w in windows]
        print(json.dumps({"config": name, "n_particles": N_FLAGSHIP,
                          "n_updates": n_upd,
                          "particle_updates_per_s":
                              N_FLAGSHIP * n_upd / statistics.median(secs),
                          "window_s": secs, "n_resamples": n_resamples,
                          "est": [w[1] for w in windows],
                          "sd": [w[2] for w in windows], "launches": counts}))
        out[name] = counts
    name, n_trials, n, n_exp = USER_ENSEMBLE
    steps = n_exp + min(n_exp, _WARMUP_EXPERIMENTS)
    runs, total = [], {}
    for seed in ENSEMBLE_SEEDS:
        _reset_counters()
        _reset_route_counters()
        seconds, perf, steps_resampled = ensemble_run(
            n_trials, n, n_exp, seed, device, model=LostVisibilityModel(),
            prior=qt.UniformDistribution(USER_PRIOR))
        counts = {"B1": b1.fused_bayes_update.launches,
                  "B1_batched": b1.fused_bayes_update_batched.launches,
                  "B2_batched": b2.expand_sorted_segments_batched.launches,
                  **_route_counters()}
        first = float(np.median(perf["loss"][:, 0]))
        loss = float(np.median(perf["loss"][:, -1]))
        if not loss < first / 10 or not np.all(np.isfinite(perf["est"])):
            raise AssertionError(f"{name}: median loss {first} -> {loss}")
        if counts["B1_batched"] != steps or counts["B1"] != 0:
            raise AssertionError(f"{name}: B1 launches {counts}, expected "
                                 f"{steps} batched, 0 single")
        _check_routes(name, counts, {"B1_batched_user": steps})
        if steps_resampled == 0 or counts["B2_batched"] < steps_resampled:
            raise AssertionError(f"{name}: B2 batched launched "
                                 f"{counts['B2_batched']} times for "
                                 f"{steps_resampled} resampling steps")
        runs.append({"seconds": seconds, "first": first, "loss": loss,
                     "steps_resampled": steps_resampled})
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    secs = [r["seconds"] for r in runs]
    print(json.dumps({
        "config": name, "n_trials": n_trials, "n_particles": n,
        "n_exp": n_exp,
        "ensemble_particle_updates_per_s":
            n_trials * n * n_exp / statistics.median(secs),
        "wall_s": secs, "median_first_loss": [r["first"] for r in runs],
        "median_final_loss": [r["loss"] for r in runs],
        "steps_resampled": [r["steps_resampled"] for r in runs],
        "launches": total}))
    out[name] = total
    return out


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


def _alternate(plain, kernel, library=None, old=None, iters=20):
    """plain, kernel, [old,] [library, library,] [old,] kernel, plain; the
    mean of each pair, in ms: {"ms", "plain_ms", "library_ms", "old_ms"}
    (None without a library call or an old form)."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    old_ms = lib = None
    if old is not None:
        old_ms = _time_ms(old, iters)
    if library is not None:
        lib = (_time_ms(library, iters) + _time_ms(library, iters)) / 2
    if old is not None:
        old_ms = (old_ms + _time_ms(old, iters)) / 2
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
            "old_ms": old_ms}


def b1_two_pass(tile, scal, lw, cols):
    """The call that B1's wrapper made before the one-launch form (two
    passes and the wrapper's lw − lse) on T banks, or None where the
    wrapper's path has only that form (the row span)."""
    if b1._row_span(cols) is not None:
        return None
    return lambda: b1._fused_update_cuda(tile, scal, lw, cols,
                                         form=b1.TWO_PASS, normalize=True)


def b1_plan(tile, lw, cols):
    """The form and grid the wrapper takes for these (T, N) inputs."""
    if b1._row_span(cols) is not None:
        return "row span, two passes"
    outcome, functor, _, source = b1._kernel_of(tile)
    cap = b1._capacity(outcome, functor, len(cols), lw.shape[0] > 1,
                       lw.device.index, source)
    return "{} (n_blocks {}, blocks {}, per block {}, capacity {})".format(
        *b1.grid_plan(lw.shape[0], lw.shape[1], cap)[:4], cap)


# The card's peaks (H100 SXM data sheet, at 700 W): HBM bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def b1_work(n_cols, n):
    """(bytes, operations) of B1 over n particles: log_w and n_cols columns
    read once, lw written once; per particle the pr1's product and sum per
    column and about twelve more (outcome composition, clip, log, the
    update's add and the streaming log-sum-exp's exp, compares and sums)."""
    return (8 + 4 * n_cols) * n, (12 + 2 * n_cols) * n


def b2_work(starts, n_cols, n_out):
    """(bytes, operations) of B2 on these starts: every start read once,
    the D values of each particle that this run picks read once, the
    (n_out, D) output written once; per output row a binary search over
    the starts and the affine's product and sum per column."""
    n_in = starts.shape[-1]
    last = torch.full(starts.shape[:-1] + (1,), n_out, dtype=torch.int64,
                      device=starts.device)
    counts = torch.diff(torch.cat([starts.to(torch.int64), last], -1), dim=-1)
    picked = int((counts > 0).sum())
    rows = n_out * (starts.numel() // n_in)
    bytes_ = 4 * starts.numel() + 4 * n_cols * picked + 4 * n_cols * rows
    ops = rows * (int(np.ceil(np.log2(n_in))) + 2 * n_cols)
    return bytes_, ops


def bound(work):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the f32 rate."""
    bytes_, ops = work
    by_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def _repeat_interleave(starts, vals, n_out):
    """The one PyTorch call that picks as B2 does (without the affine):
    ``torch.repeat_interleave`` of the values by their segment lengths."""
    last = torch.full(starts.shape[:-1] + (1,), n_out, dtype=torch.int64,
                      device=starts.device)
    counts = torch.diff(torch.cat([starts.to(torch.int64), last], -1),
                        dim=-1).reshape(-1)
    flat = vals.reshape(-1, vals.shape[-1])
    total = n_out * (starts.numel() // starts.shape[-1])
    return lambda: torch.repeat_interleave(flat, counts, dim=0,
                                           output_size=total)


def phase_timing(device):
    """B1 (flagship tile) and B2 at D = 1, 2, 3, 4, 16 at 2^20: kernel,
    plain, and for B2 the library call."""
    tile = b1.two_outcome_tile(b1.precession_pr1)
    omega, lw = _b1_inputs(N_FLAGSHIP, 7, device)
    scal = torch.tensor([1.0, 17.3], device=device)

    def b1_plain():
        lw_u, lse, _, ess = b1.fused_update_plain(tile, scal, lw, (omega,))
        return lw_u - lse, lse, ess

    times = {"B1": _alternate(
        b1_plain, lambda: b1.fused_bayes_update(tile, scal, lw, (omega,)),
        old=b1_two_pass(tile, scal[None], lw[None], (omega[None],)))}
    times["B1"]["work"] = b1_work(1, N_FLAGSHIP)
    times["B1"]["form"] = b1_plan(tile, lw[None], (omega[None],))

    rng = np.random.default_rng(1)
    log_w = torch.as_tensor(_weights("random", N_FLAGSHIP, rng), device=device)
    starts = systematic_segment_starts(log_w, N_FLAGSHIP, u0=0.37)
    for d in (1, 2, 3, 4, 16):
        vals = torch.rand((N_FLAGSHIP, d), device=device)
        affine = b2._affine(0.98, 0.02 * vals.mean(0), d, device)
        name = "B2" if d == 1 else f"B2[D={d}]"
        times[name] = _alternate(
            lambda: b2.expand_plain(starts, vals, N_FLAGSHIP, affine),
            lambda: b2._expand_cuda(starts, vals, N_FLAGSHIP, affine),
            _repeat_interleave(starts, vals, N_FLAGSHIP),
            old=None if d > 8 else lambda: b2._expand_cuda_batched(
                starts[None], vals[None], N_FLAGSHIP, affine[None],
                form=b2.ROWS))
        times[name]["work"] = b2_work(starts, d, N_FLAGSHIP)
        times[name]["form"] = b2.kernel_form(d, 2 * N_FLAGSHIP)
    for name, t in times.items():
        print(f"{name} at 2^20: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, "
              f"bound {bound(t['work'])[0]:.4f} ms")
    print(json.dumps({"old_form_ms_at_2^20": {
        name: {"ms": t["ms"], "old_ms": t["old_ms"], "form": t["form"]}
        for name, t in times.items()}}))
    return times


def phase_timing_zoo(device):
    """B1 with each ZOO tile and each TOMO tile at 2^20, kernel against
    plain (no single PyTorch call computes B1)."""
    times = {}
    inputs = [(case[0], zoo_inputs(case, N_FLAGSHIP, 7, device))
              for case in ZOO]
    inputs += [(case[0], tomo_inputs(case, N_FLAGSHIP, 7, device))
               for case in TOMO]
    for name, (tile, scal, lw, cols) in inputs:

        def plain():
            lw_u, lse, _, ess = b1.fused_update_plain(tile, scal, lw, cols)
            return lw_u - lse, lse, ess

        batch = (scal[None], lw[None], tuple(c[None] for c in cols))
        times[name] = _alternate(
            plain, lambda: b1.fused_bayes_update(tile, scal, lw, cols),
            old=b1_two_pass(tile, *batch))
        times[name]["work"] = b1_work(len(cols), N_FLAGSHIP)
        times[name]["form"] = b1_plan(tile, *batch[1:])
    print(json.dumps({"b1_tile_old_form_ms_at_2^20": {
        name: {"ms": t["ms"], "old_ms": t["old_ms"], "form": t["form"]}
        for name, t in times.items()}}))
    print(json.dumps({"b1_tile_ms_at_2^20": {
        name: {"ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": bound(t["work"])[0]}
        for name, t in times.items()}}))
    return times


def phase_timing_batched(device, b2_inputs):
    """Batched B1 (the ensembles' precession tile) in both ensemble
    regimes, and batched B2 on ``b2_inputs`` (per regime, the inputs of a
    resample that the path made, from ``phase_ensembles``; bit-equal to its
    plain version or it raises): kernel, plain, and for B2 the library
    call."""
    times = {}
    for n_trials, n in B1_BATCH_SHAPES[:2]:
        tile, scal, lw, cols = batched_b1_inputs("precession", n_trials, n, 7,
                                                 device)

        def plain():
            lw_u, lse, _, ess = b1.fused_update_plain_batched(tile, scal, lw,
                                                              cols)
            return lw_u - lse[:, None], lse, ess

        t = _alternate(plain, lambda: b1.fused_bayes_update_batched(
            tile, scal, lw, cols), old=b1_two_pass(tile, scal, lw, cols))
        t["work"] = b1_work(1, n_trials * n)
        t["shape"] = [n_trials, n, 1]
        t["form"] = b1_plan(tile, lw, cols)
        times[f"B1_batched[{n_trials}x{n}]"] = t
    for name, (starts, vals, scale, shift) in b2_inputs.items():
        n_trials, n, d = vals.shape
        affine = b2._affine_batched(scale, shift, n_trials, d, device)
        out_k = b2._expand_cuda_batched(starts, vals, n, affine)
        out_m = b2._expand_cuda_batched(starts, vals, n, affine, form=b2.MERGE)
        out_p = b2.expand_plain_batched(starts, vals, n, affine)
        torch.cuda.synchronize()
        if not (torch.equal(out_k, out_p) and torch.equal(out_m, out_p)):
            raise AssertionError(f"batched B2 differs from its plain version "
                                 f"on {name}'s resample")
        t = _alternate(
            lambda: b2.expand_plain_batched(starts, vals, n, affine),
            lambda: b2._expand_cuda_batched(starts, vals, n, affine),
            _repeat_interleave(starts, vals, n),
            old=lambda: b2._expand_cuda_batched(starts, vals, n, affine,
                                                form=b2.ROWS))
        t["work"] = b2_work(starts, d, n)
        t["shape"] = [n_trials, n, d]
        t["form"] = b2.kernel_form(d, n_trials * 2 * n)
        times[f"B2_batched[{name}]"] = t
    print(json.dumps({"batched_old_form_ms": {
        name: {"ms": t["ms"], "old_ms": t["old_ms"], "form": t["form"]}
        for name, t in times.items()}}))
    print(json.dumps({"batched_ms": {
        name: {"ms": t["ms"], "plain_ms": t["plain_ms"],
               "library_ms": t["library_ms"], "bound_ms": bound(t["work"])[0],
               "shape": t["shape"]}
        for name, t in times.items()}}))
    return times


def phase_timing_sharded(device):
    """B2 on rank 1's window of a bank over 4 ranks (n_in = 2^20, n_out =
    2^18, D = 1) beside its plain version and ``repeat_interleave`` over
    the window's counts, its bound from the starts this window needs (the
    last at 0 to the first past it) and the rows they pick; and B1 with
    ``return_stats`` (the sharded step's call) for the precession and
    born4 tiles at 2^20."""
    n = N_FLAGSHIP
    n_local = n // 4
    rng = np.random.default_rng(1)
    log_w = torch.as_tensor(_weights("random", n, rng), device=device)
    shifted = shard_windows(log_w, 4, 0.37)[1][1]
    vals = torch.rand((n, 1), device=device)
    affine = b2._affine(0.98, 0.02 * vals.mean(0), 1, device)
    edges = torch.tensor([0, n_local], dtype=torch.int32, device=device)
    lo = int(torch.searchsorted(shifted, edges[:1], right=True)) - 1
    hi = int(torch.searchsorted(shifted, edges[1:]))  # first past the window
    needed = shifted[lo:hi]
    times = {"B2_window": _alternate(
        lambda: b2.expand_plain(shifted, vals, n_local, affine),
        lambda: b2._expand_cuda(shifted, vals, n_local, affine),
        _repeat_interleave(needed, vals[lo:hi], n_local),
        old=lambda: b2._expand_cuda_batched(
            shifted[None], vals[None], n_local, affine[None], form=b2.ROWS))}
    times["B2_window"]["work"] = b2_work(needed, 1, n_local)
    times["B2_window"]["form"] = b2.kernel_form(1, n + n_local)
    omega, lw = _b1_inputs(n, 7, device)
    cases = {"B1_stats": (b1.two_outcome_tile(b1.precession_pr1),
                          torch.tensor([1.0, 17.3], device=device), lw,
                          (omega,)),
             "born4_stats": tomo_inputs(TOMO[0], n, 7, device)}
    for name, (tile, scal, lw, cols) in cases.items():
        times[name] = _alternate(
            lambda: b1.fused_update_plain(tile, scal, lw, cols)[:3],
            lambda: b1.fused_bayes_update(tile, scal, lw, cols,
                                          return_stats=True))
        times[name]["work"] = b1_work(len(cols), n)
    print(json.dumps({"sharded_ms": {
        name: {"ms": t["ms"], "plain_ms": t["plain_ms"],
               "library_ms": t["library_ms"], "old_ms": t["old_ms"],
               "bound_ms": bound(t["work"])[0]}
        for name, t in times.items()}}))
    return times


def phase_timing_user(device):
    """B1 on the user model's tile at 2^20: the user functor (two-outcome,
    and beside it the built-in two-column multicos in the same turns;
    binomial), the column route (the torch pr1 and B1 on GivenPr1, beside
    it B1 on GivenPr1 alone) and the trial grid at 256 × 2048, each against
    its plain version. The bound is that of the same function: log_w and
    two columns read once, lw written once."""
    times = {}
    multicos = zoo_inputs(ZOO[0], N_FLAGSHIP, 7, device)
    for binomial in (False, True):
        tile, scal, lw, cols = user_inputs(binomial, N_FLAGSHIP, 7, device)
        times["binomial" if binomial else "two_outcome"] = _alternate(
            lambda: b1.fused_update_plain(tile, scal, lw, cols),
            lambda: b1.fused_bayes_update(tile, scal, lw, cols),
            old=None if binomial else lambda: b1.fused_bayes_update(
                *multicos))
    tile, scal, lw, cols = user_inputs(False, N_FLAGSHIP, 7, device)
    twin = type(tile)(LOST_VISIBILITY_TORCH)
    given, scal_g, cols_g, _ = b1._route(twin, scal, cols, lw.shape,
                                         batched=False)
    times["column"] = _alternate(
        lambda: b1.fused_update_plain(tile, scal, lw, cols),
        lambda: b1.fused_bayes_update(twin, scal, lw, cols),
        old=lambda: b1.fused_bayes_update(given, scal_g, lw, cols_g))
    for t in times.values():
        t["work"] = b1_work(2, N_FLAGSHIP)
    n_trials, n = B1_BATCH_SHAPES[0]
    tile, scal, lw, cols = user_batched_inputs(n_trials, n, 7, device)
    times["batched"] = _alternate(
        lambda: b1.fused_update_plain_batched(tile, scal, lw, cols),
        lambda: b1.fused_bayes_update_batched(tile, scal, lw, cols))
    times["batched"]["work"] = b1_work(2, n_trials * n)
    print(json.dumps({"user_tile_ms": {
        name: {"ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": bound(t["work"])[0],
               {"two_outcome": "builtin_multicos_ms",
                "column": "b1_given_pr1_ms"}.get(name, "old_ms"): t["old_ms"]}
        for name, t in times.items()}}))
    return times


def kernel_row(name, source, replaces, launches, max_abs_err, t):
    """One entry of the kernels line from a timing record ``t``."""
    bound_ms, bound_by = bound(t["work"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    err = {"B1": phase_compare_b1(device), "B2": phase_compare_b2(device)}
    zoo_err = phase_compare_zoo(device)
    zoo_err.update(phase_compare_tomo(device))
    zoo_err["binomial_tomography_2q"] = max(
        zoo_err["binomial_tomography_2q"], phase_compare_span(device))
    batched_err = {"B1": phase_compare_b1_batched(device),
                   "B2": phase_compare_b2_batched(device)}
    launches = phase_main_path(device)
    config_launches = phase_configs(device)
    config_launches["config5_adaptive_tomography"] = phase_config5(device)
    config_launches["tomography_2q_binomial"] = phase_tomography_2q(device)
    pgh_launches = phase_pgh_paths(device)
    ens_launches, b2_inputs = phase_ensembles(device)
    api_launches = phase_engine_api(device)
    zoo_launches = phase_model_zoo(device)
    phase_samplers(device)
    sharded_err = phase_compare_sharded(device)
    sharded_launches = phase_sharded(device, smi)
    phase_aux(device)
    # Every shipped path ran on a built-in functor: no B1 launch so far
    # took a user library or the column route.
    print(json.dumps({"shipped_paths_b1_routes": _route_counters()}))
    _check_routes("the shipped paths", _route_counters(), {})
    user_err = phase_compare_user(device)
    user_launches = phase_user_tile(device)
    times = phase_timing(device)
    zoo_times = phase_timing_zoo(device)
    batched_times = phase_timing_batched(device, b2_inputs)
    sharded_times = phase_timing_sharded(device)
    user_times = phase_timing_user(device)
    src1 = "qinfer_tpu_torch/csrc/fused_update.cu"
    src2 = "qinfer_tpu_torch/csrc/resample_expand.cu"
    b1_line = "qinfer_tpu/ops/fused_update.py:{}".format
    b2_kernel = "qinfer_tpu/ops/resample_expand.py:115"
    kernels = [
        kernel_row("fused_bayes_update", src1, b1_line(36), launches["B1"],
                   err["B1"], times["B1"]),
        kernel_row("expand_sorted_segments", src2, b2_kernel, launches["B2"],
                   err["B2"], times["B2"]),
        kernel_row("expand_sorted_segments[D=4]", src2, b2_kernel,
                   config_launches["config5_adaptive_tomography"]["B2"],
                   err["B2"], times["B2[D=4]"]),
        kernel_row("expand_sorted_segments[D=16]", src2, b2_kernel,
                   config_launches["tomography_2q_binomial"]["B2"],
                   err["B2"], times["B2[D=16]"]),
    ]
    tile_line = {case[0]: case[5] for case in ZOO}
    rows = [(cfg, tile, tile, tile_line[tile])
            for cfg, tile in CONFIG_TILE.items()]
    rows += [(cfg, tile, label, 347)  # make_born_pr1
             for cfg, (tile, label) in TOMO_TILE.items()]
    for cfg_name, tile, label, line in rows:
        kernels.append(kernel_row(
            f"fused_bayes_update[{label}]", src1, b1_line(line),
            config_launches[cfg_name]["B1"], zoo_err[tile], zoo_times[tile]))
    kernels.append(kernel_row(
        "fused_bayes_update[known_t2, PGH]", src1, b1_line(299),
        pgh_launches["config4_known_t2_pgh"]["B1"], zoo_err["known_t2"],
        zoo_times["known_t2"]))
    for name, n_trials, n, _ in ENSEMBLES:
        kernels.append(kernel_row(
            f"fused_bayes_update_batched[{n_trials}x{n}]", src1, b1_line(197),
            ens_launches[name]["B1_batched"], batched_err["B1"],
            batched_times[f"B1_batched[{n_trials}x{n}]"]))
        t = batched_times[f"B2_batched[{name}]"]
        kernels.append(kernel_row(
            "expand_sorted_segments_batched[{}x{} of {}]".format(
                *t["shape"][:2], name), src2,
            "qinfer_tpu/ops/resample_expand.py:359",
            ens_launches[name]["B2_batched"], batched_err["B2"], t))
    flagship_api = ("flagship_bcrb", "flagship_track_rsd", "mixed_ale")
    kernels += [
        kernel_row("fused_bayes_update[precession, engine API paths]", src1,
                   b1_line(36), sum(api_launches[p]["B1"] for p in flagship_api),
                   err["B1"], times["B1"]),
        kernel_row("expand_sorted_segments[engine API paths]", src2,
                   b2_kernel, sum(api_launches[p]["B2"] for p in flagship_api),
                   err["B2"], times["B2"]),
        kernel_row("fused_bayes_update[multicos, posterior_summaries]", src1,
                   b1_line(286), api_launches["posterior_summaries"]["B1"],
                   zoo_err["multicos"], zoo_times["multicos"]),
        kernel_row("expand_sorted_segments[D=2, posterior_summaries]", src2,
                   b2_kernel, api_launches["posterior_summaries"]["B2"],
                   err["B2"], times["B2[D=2]"]),
    ]
    kernels += [
        kernel_row(f"expand_sorted_segments[D={d}, {name}]", src2, b2_kernel,
                   zoo_launches[name]["B2"], err["B2"], times[timing])
        for d, name, timing in ((1, "random_walk_tracking", "B2"),
                                (2, "gaussian_walk_drift", "B2[D=2]"),
                                (3, "multinomial_die", "B2[D=3]"))]
    precession_paths = ("sharded_flagship", "sharded_flagship_ring",
                        "sharded_config1_pgh")
    kernels += [
        kernel_row("fused_bayes_update[precession, sharded, return_stats]",
                   src1, b1_line(36),
                   sum(sharded_launches[p]["B1"] for p in precession_paths),
                   sharded_err["precession"], sharded_times["B1_stats"]),
        kernel_row("fused_bayes_update[born4, sharded episode]", src1,
                   b1_line(347), sharded_launches["sharded_config5_eig"]["B1"],
                   sharded_err["born4"], sharded_times["born4_stats"]),
        kernel_row("expand_sorted_segments[sharded window]", src2, b2_kernel,
                   sum(sharded_launches[p]["B2"] for p in precession_paths),
                   sharded_err["B2"], sharded_times["B2_window"]),
        kernel_row("expand_sorted_segments[D=4, sharded episode]", src2,
                   b2_kernel, sharded_launches["sharded_config5_eig"]["B2"],
                   sharded_err["B2"], times["B2[D=4]"]),
    ]
    user_src = "qinfer_tpu_torch/csrc/fused_update.cuh"
    user_b1 = b1_line(36)  # the model's own pr1 tile: :239-245
    kernels += [
        kernel_row("fused_bayes_update[user pr1: chip_smoke."
                   "LOST_VISIBILITY_SOURCE]", user_src, user_b1,
                   user_launches["user_tile"]["B1_user"],
                   user_err["two_outcome"], user_times["two_outcome"]),
        kernel_row("fused_bayes_update[user pr1, binomial]", user_src,
                   user_b1, user_launches["user_tile_binomial"]["B1_user"],
                   user_err["binomial"], user_times["binomial"]),
        kernel_row("fused_bayes_update[column route: torch pr1 + GivenPr1]",
                   src1, user_b1,
                   user_launches["user_tile_column"]["B1_column"],
                   user_err["column_two_outcome"], user_times["column"]),
        kernel_row("fused_bayes_update_batched[user pr1, {}x{}]".format(
                       *B1_BATCH_SHAPES[0]), user_src, b1_line(197),
                   user_launches["user_tile_ensemble"]["B1_batched_user"],
                   user_err["batched"], user_times["batched"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
