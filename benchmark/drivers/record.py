"""Driver ``record``: fixed records through ``smc_batch_update``.

A unit is one record of ``n_exp`` single-shot outcomes at the times
min((9/8)^k, ``t_cap``), drawn from the seed at the traffic's ``omega``
(the repository bench's record), run through ``smc.smc_batch_update`` from
a fresh bank of the configuration's particles drawn on the card from the
seed. The user's answer is the posterior's mean and standard deviation
and the record's log evidence (the sum of the step's log-norms), read on
the host when the unit ends.

``correct`` compares a sample of the window's units, drawn from the seed,
with the plain reference's exact posterior of the same record: the gap
of the means in standard deviations of the exact posterior, the log
ratio of the standard deviations, and the gap of the log evidences, each
as the median over the sample. Not the widest: Liu–West loses the
posterior's mode on about 2 % of these records (the estimate hundreds of
standard deviations off), on the program's kernel path and on its plain
torch path alike, and on an independent plain SMC; the median is steady
from seed to seed, and a fault that touches every unit moves it.
"""

from __future__ import annotations

import math

import torch

from harness import compare, inputs, port, roofline
from harness.driver import Base, span


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        tr = self.traffic
        self.sys = port.build(self.config, tr.get("n_particles"))
        self.n_exp = int(tr["n_exp"])
        self.max_units = int(tr["max_units"])
        self.ts, self.outcomes = inputs.records(
            self.seed, self.max_units, self.n_exp, tr["omega"], tr["t_cap"])
        self.ts_dev = torch.as_tensor(self.ts, device=self.device)
        self.out_dev = torch.as_tensor(self.outcomes, device=self.device)
        self.answers = []  # per unit: mean, sd, log evidence, resamples
        self.n_cols = int(self.config["b1_columns"])
        self.d = int(self.config["dimensions"])

    def _run(self, bank_key, record):
        from qinfer_tpu_torch import smc

        s = self.sys
        with span("bank"):
            state = smc.init_smc_state(self.generator(*bank_key), s.model,
                                       s.n_particles, s.prior)
        with span("update"):
            state, log_norms = smc.smc_batch_update(
                s.model, s.resampler, s.smc_config, state,
                self.out_dev[record], {"t": self.ts_dev})
        with span("answer"):
            x = state.particle_locations[:, 0].to(torch.float64)
            w = torch.exp(state.particle_log_weights.to(torch.float64))
            w = w / w.sum()
            mean = w @ x
            var = w @ (x - mean) ** 2
            row = torch.stack([mean, torch.sqrt(var),
                               log_norms.to(torch.float64).sum(),
                               state.n_resamples.to(torch.float64)])
            return row.cpu().numpy()

    def setup(self):
        self._run(("warm",), 0)
        self.sync()

    def unit(self, i):
        row = self._run(("bank", i), i % self.max_units)
        self.answers.append(row)
        n = self.sys.n_particles
        res = int(row[3])
        self.count["steps"] += self.n_exp
        self.count["updates"] += self.n_exp
        self.count["resamples"] += res
        self.count["b1_bytes"] += self.n_exp * roofline.b1_bytes(n,
                                                                 self.n_cols)
        self.count["b2_bytes"] += res * roofline.b2_bytes(n, n, self.d)
        return {"work": n * self.n_exp, "steps": self.n_exp}

    def check(self, control=False):
        return check_records(self.cell, self.seed, self.ts, self.outcomes,
                             self.answers, control, self.device)


def check_records(cell, seed, ts, outcomes, answers, control=False,
                  device="cpu"):
    """The gaps of a sample of the units' answers (mean, sd, log evidence)
    from the exact posterior of their records; with ``control``, of the
    reference's own answers computed in bfloat16 in their place."""
    ref = cell.module("reference", cell.config["reference"])
    lo, hi = cell.config["prior"]["kwargs"]["ranges"][0]
    lim = cell.traffic["limits"]
    picks = inputs.sample(seed, len(answers), int(cell.traffic["check_units"]),
                          "units")
    gaps = {"mean_gap_median": [], "sd_ratio_median": [],
            "evidence_gap_median": []}
    for i in picks:
        rec = outcomes[i % len(outcomes)]
        exact = ref.posterior(ts, rec, lo, hi, device=device)
        if control:
            ctl = ref.posterior(ts, rec, lo, hi, dtype=torch.bfloat16,
                                device=device)
            mean, sd, ev = ctl["mean"], ctl["sd"], ctl["log_evidence"]
        else:
            mean, sd, ev = (float(v) for v in answers[i][:3])
        gaps["mean_gap_median"].append(abs(mean - exact["mean"])
                                       / exact["sd"])
        gaps["sd_ratio_median"].append(
            abs(math.log(sd / exact["sd"])) if sd > 0 else math.inf)
        gaps["evidence_gap_median"].append(abs(ev - exact["log_evidence"]))
    return [compare.median(k, v, lim[k]) for k, v in gaps.items()]
