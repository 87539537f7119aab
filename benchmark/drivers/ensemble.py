"""Driver ``ensemble``: trial ensembles through ``perf_test_multiple``.

A unit is one call of ``perf_testing.perf_test_multiple(trials, model,
particles, prior, n_exp, PGH)`` with the configuration's resampler and
settings, on a generator seeded from the seed (the call's own warm-up
included, as a user pays it). Each trial's truth is drawn from the prior,
PGH proposes its times from its own posterior and the outcomes are
simulated at the truth, all by the program. The harness wraps PGH to keep
the times it proposed; the user's answer is the structured record
(outcomes, estimates) that the call returns.

``correct`` takes a sample of the trials of a sample of the window's
units, both drawn from the seed, and compares each trial's final
estimate with the plain reference's exact posterior of that trial's
record (its times and outcomes, under the prior): the gap of the means
over the larger of the exact posterior's standard deviation and the f32
spacing of the mean (the configuration's precision; PGH's ensembles
narrow their posteriors down to it). The number compared is the 75th
percentile over the sampled trials: not the widest, since about 1 % of
PGH's trials at 2048 particles lose the posterior's mode (the soak's
0.8 % of chains, PERF.md), and not the median, which a fault in half of
the trials would not move.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import compare, inputs, port, roofline
from harness.driver import Base, span


class _RecordingPGH:
    """PGH's propose, keeping each proposal's times on the device. (It has
    no ``core``: ``perf_test_multiple`` would take that instead.)"""

    def __init__(self, pgh, sink):
        self._pgh, self.sink = pgh, sink

    def propose(self, generator, state, step_idx):
        ep = self._pgh.propose(generator, state, step_idx)
        self.sink.append(ep["t"])
        return ep


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        tr = self.traffic
        self.sys = port.build(self.config, tr["particles"])
        self.trials = int(tr["trials"])
        self.n_exp = int(tr["n_exp"])
        self.check_units = set(inputs.sample(
            self.seed, int(tr["check_span_units"]), int(tr["check_units"]),
            "units"))
        self.kept = {}
        self.n_cols = int(self.config["b1_columns"])
        self.d = int(self.config["dimensions"])

    def _heuristic(self, sink):
        from qinfer_tpu_torch.heuristics import PGH

        def make(updater):
            return _RecordingPGH(PGH(updater).core, sink)

        return make

    def _run(self, key, i):
        from qinfer_tpu_torch import perf_testing

        s = self.sys
        sink = []
        with span("ensemble"):
            out = perf_testing.perf_test_multiple(
                self.trials, s.model, s.n_particles, s.prior, self.n_exp,
                self._heuristic(sink), resampler=s.resampler,
                extra_updater_args=self.config["smc"],
                seed=inputs.derive(self.seed, key, "warm", i),
                generator=self.generator(key, i), device=self.device)
        return out, sink[-self.n_exp:]

    def setup(self):
        self._run("warm", 0)
        self.sync()

    def unit(self, i):
        out, ts = self._run("ensemble", i)
        if i in self.check_units:
            self.kept[i] = {
                "ts": torch.stack(ts, 1).cpu().numpy(),
                "outcomes": out["outcome"].astype(np.int64),
                "est": out["est"][:, -1, 0].copy()}
        res = int(out["resample_count"][:, -1].sum())
        n = self.sys.n_particles
        self.count["steps"] += self.n_exp
        self.count["updates"] += self.n_exp
        self.count["resamples"] += res
        self.count["b1_bytes"] += self.n_exp * roofline.b1_bytes(
            self.trials * n, self.n_cols)
        self.count["b2_bytes"] += res * roofline.b2_bytes(n, n, self.d)
        return {"work": self.trials * n * self.n_exp, "steps": self.n_exp}

    def check(self, control=False):
        ref = self.cell.module("reference", self.config["reference"])
        lo, hi = self.config["prior"]["kwargs"]["ranges"][0]
        lim = self.traffic["limits"]
        gaps = []
        for i, rec in sorted(self.kept.items()):
            picks = inputs.sample(self.seed, self.trials,
                                  int(self.traffic["check_trials"]),
                                  "trials", i)
            for j in picks:
                exact = ref.posterior(rec["ts"][j], rec["outcomes"][j], lo, hi,
                                      device=self.device)
                if control:
                    est = ref.posterior(rec["ts"][j], rec["outcomes"][j], lo,
                                        hi, dtype=torch.bfloat16,
                                        device=self.device)["mean"]
                else:
                    est = float(rec["est"][j])
                m = exact["mean"]
                spacing = float(np.spacing(np.float32(abs(m))))
                gaps.append(abs(est - m) / max(exact["sd"], spacing))
        return [compare.quantile("mean_gap_q75", gaps, 75,
                                 lim["mean_gap_q75"])]
