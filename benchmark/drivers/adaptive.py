"""Driver ``adaptive``: adaptive experiment design, one step at a time.

A unit is an episode of ``steps`` steps on a fresh bank of the
configuration's particles drawn on the card from the seed, at a true
state from a fixed pool spread over the Bloch ball by the full-rank
Ginibre prior's measure, in an order drawn from the seed. A step: the
outcome is drawn on the card at the truth under the chosen effect,
``smc.smc_update_step`` updates the bank (and resamples when due),
``smc.expected_information_gain_fn`` scores the configuration's candidate
effects and the argmax is read on the host: the next experiment. The
step's time (``step_ms``) runs from the outcome handed in to that index on
the host; the design's (``design_ms``) from the update's end on the
device to it; both by CUDA events.

``correct`` follows the program step by step from its own state, at a
sample of the window's steps drawn from the seed: the plain reference
recomputes, in float64 from the bank before the step, the weights after
the update (on steps that did not resample), the step's log evidence,
and the information gain of every candidate from the bank after the
step. At every step that resampled in a sample of the episodes, it
updates the bank before the step and resamples it by Liu–West itself,
with draws of its own: the program's resampled bank must have the
reference's mean and covariance, to within the Monte-Carlo error of two
banks of that size, and hold states only.
"""

from __future__ import annotations

import statistics
import sys

import torch

from harness import compare, inputs, port, roofline, stats
from harness.driver import Base, SpanClock, span


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        tr = self.traffic
        self.sys = port.build(self.config, tr.get("n_particles"))
        self.steps = int(tr["steps"])
        self.max_units = int(tr["max_units"])
        self.effects = torch.tensor(self.config["effects"],
                                    dtype=torch.float32, device=self.device)
        self.truths = torch.as_tensor(
            inputs.bloch_ball_truths(self.seed, self.max_units,
                                     int(tr["truth_pool"])),
            device=self.device)
        span_ = int(tr["check_span_units"])
        self.check_steps = set(inputs.sample(
            self.seed, span_ * self.steps, int(tr["check_steps"]), "steps"))
        self.check_units = set(inputs.sample(
            self.seed, span_, int(tr["check_units"]), "banks"))
        self.clock = SpanClock(self.device, self.steps, 3)
        self.n_cols = int(self.config["b1_columns"])
        self.d = int(self.config["dimensions"])
        self._reset()

    def _reset(self):
        self.kept = []
        self.step_ms = []
        self.count.clear()
        self.count["design_ms"] = []

    def _episode(self, i, sampled, whole):
        """Episode ``i``; keeps the steps ``sampled`` (indices within the
        episode) and, with ``whole``, every step that resampled."""
        from qinfer_tpu_torch import smc

        s = self.sys
        cand = {"meas": self.effects}
        truth = self.truths[i % self.max_units]
        sim = self.generator("outcome", i)
        trail = []
        with span("bank"):
            state = smc.init_smc_state(self.generator("bank", i), s.model,
                                       s.n_particles, s.prior)
        with span("design"):
            ig = smc.expected_information_gain_fn(s.model, state, cand)
            k = int(torch.argmax(ig))
        for step in range(self.steps):
            self.clock.mark(step, 0)
            effect = self.effects[k:k + 1]
            pr1 = torch.clamp(torch.sum(truth * effect[0]), 0.0, 1.0)
            outcome = (torch.rand((), generator=sim, device=self.device)
                       < pr1).to(torch.int32)
            before = state
            with span("update"):
                state, log_norm = smc.smc_update_step(
                    s.model, s.resampler, s.smc_config, state, outcome,
                    {"meas": effect})
            self.clock.mark(step, 1)
            with span("design"):
                ig = smc.expected_information_gain_fn(s.model, state, cand)
                best = torch.argmax(ig)
                self.clock.mark(step, 2)
                k_next = int(best)
            if whole or step in sampled:
                trail.append({
                    "sampled": step in sampled, "unit": i, "step": step,
                    "locs": before.particle_locations,
                    "log_w": before.particle_log_weights,
                    "effect": k, "outcome": outcome,
                    "after_locs": state.particle_locations,
                    "after_log_w": state.particle_log_weights,
                    "log_norm": log_norm, "ig": ig,
                    "resampled": state.just_resampled})
            k = k_next
        resamples = int(state.n_resamples)
        if trail:
            flags = torch.stack([st["resampled"] for st in trail]).tolist()
            for st, flag in zip(trail, flags):
                st["resampled"] = bool(flag)
            self.kept += [st for st in trail
                          if st["sampled"] or st["resampled"]]
        return resamples

    def _sampled(self, i):
        return {j - i * self.steps for j in self.check_steps
                if i * self.steps <= j < (i + 1) * self.steps}

    def setup(self):
        # One warm episode that keeps as many states as a checked one, so
        # that the allocator holds their memory before the clock starts.
        self._episode(0, set(range(len(self.check_steps))), True)
        self.sync()
        self._reset()

    def unit(self, i):
        res = self._episode(i, self._sampled(i), i in self.check_units)
        self.step_ms += self.clock.ms(0, 2, self.steps)
        self.count["design_ms"] += self.clock.ms(1, 2, self.steps)
        n = self.sys.n_particles
        self.count["steps"] += self.steps
        self.count["updates"] += self.steps
        self.count["resamples"] += res
        self.count["b1_bytes"] += self.steps * roofline.b1_bytes(n,
                                                                 self.n_cols)
        self.count["b2_bytes"] += res * roofline.b2_bytes(n, n, self.d)
        return {"work": n * self.steps, "steps": self.steps}

    def end_to_end(self):
        p99, beyond = stats.percentile(self.step_ms, 99)
        print(f"step_ms: p99 {p99!r} over {len(self.step_ms)} steps, "
              f"{beyond} beyond it; median "
              f"{statistics.median(self.step_ms)!r}", file=sys.stderr)
        return {"step_ms_p99": p99}

    def release(self):
        self.sys = None

    def check(self, control=False):
        ref = self.cell.module("reference", self.config["reference"])
        lim = self.traffic["limits"]
        g = self.config["guarantees"]
        lw = self.config["resampler"]["kwargs"]
        f64 = torch.float64
        dtype = torch.bfloat16 if control else None
        upd, ev, eig, mean_z, cov_z, bad = [], [], [], [], [], []
        for st in self.kept:
            effect = self.effects[st["effect"]]
            outcome = int(st["outcome"])
            w_ref, ln_ref = ref.update(st["locs"], st["log_w"], effect,
                                       outcome, f64)
            ig_ref = ref.information_gain(st["after_locs"], st["after_log_w"],
                                          self.effects, f64)
            if control:
                w, ln = ref.update(st["locs"], st["log_w"], effect, outcome,
                                   dtype)
                ig = ref.information_gain(st["after_locs"], st["after_log_w"],
                                          self.effects, dtype)
            else:
                w, ln = torch.exp(st["after_log_w"].to(f64)), st["log_norm"]
                ig = st["ig"]
            ev.append(abs(float(ln) - float(ln_ref)))
            eig.append(float(torch.max(torch.abs(ig.to(f64) - ig_ref))))
            if not st["resampled"]:
                upd.append(float(torch.max(torch.abs(w.to(f64) - w_ref))
                                 / torch.max(w_ref)))
                continue
            gen = self.generator("resample", st["unit"], st["step"])
            args = (lw["a"], lw["maxiter"], g["psd_tol"], g["trace_tol"])
            ref_locs = ref.liu_west(st["locs"], w_ref, *args, gen, f64)
            if control:
                after = ref.liu_west(st["locs"], w_ref, *args, gen, dtype)
                after_log_w = torch.zeros(after.shape[0], device=after.device)
            else:
                after, after_log_w = st["after_locs"], st["after_log_w"]
            mz, cz = ref.moment_gaps(after, after_log_w, ref_locs)
            mean_z.append(mz)
            cov_z.append(cz)
            bad.append(ref.invalid(after, g["psd_tol"] + g["f32_slack"],
                                   g["trace_tol"] + g["f32_slack"]))
        return [compare.worst("update_gap", upd, lim["update_gap"]),
                compare.worst("evidence_gap", ev, lim["evidence_gap"]),
                compare.worst("eig_gap", eig, lim["eig_gap"]),
                compare.worst("resample_mean_z", mean_z,
                              lim["resample_mean_z"]),
                compare.worst("resample_cov_z", cov_z, lim["resample_cov_z"]),
                compare.worst("invalid_states", bad, lim["invalid_states"])]
