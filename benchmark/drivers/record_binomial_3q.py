"""Driver ``record_binomial_3q``: fixed records of binomial counts through
``smc_batch_update``, for three-qubit tomography.

The two-qubit driver (``record_binomial.py``) at d = 8. A unit is one
record of the configuration's ``n_settings`` product projectors |a⟩⟨a| ⊗
|b⟩⟨b| ⊗ |c⟩⟨c| (a, b and c normalised complex Gaussians), each with
``n_shots`` shots whose count of '1' is drawn from the seed at the unit's
true state, run through ``smc.smc_batch_update`` from a fresh bank of the
configuration's particles drawn on the card from the seed. The true states
are a pool of ``truth_pool``: 0.9|GHZ⟩⟨GHZ| + 0.1·I/8 under local unitaries
U_a ⊗ U_b ⊗ U_c drawn from the seed (Haar), so that every truth has the
same spectrum; each block of ``truth_pool`` consecutive units holds every
truth once, in an order drawn from the seed. The user's answer is the
posterior's mean (64 coordinates), the trace of its covariance, the
record's log evidence and the resample count, read on the host when the
unit ends.

``correct`` is the two-qubit driver's check, on steps kept as there, but
for a bank of 256 MiB a step: the sampled steps of the window's first
``check_span_units`` units, and in the ``check_units`` units drawn from
the seed (cut at every step) the first ``check_resamples`` steps that
resampled, found by reading each step's flag on the host, and no others.
"""

from __future__ import annotations

import numpy as np
import torch

from drivers import record_binomial as two_qubit
from harness import inputs, port
from harness.driver import Base, span

DIM = 8


def truth_states(seed, pool):
    """(pool, 8, 8) complex: 0.9|GHZ⟩⟨GHZ| + 0.1·I/8 under U_a ⊗ U_b ⊗ U_c."""
    ghz = np.zeros(DIM, complex)
    ghz[0] = ghz[-1] = 1.0 / np.sqrt(2.0)
    rho = 0.9 * np.outer(ghz, ghz.conj()) + 0.1 * np.eye(DIM) / DIM
    g = inputs.rng(seed, "truth pool")
    ua, ub, uc = (two_qubit._haar(g, pool) for _ in range(3))
    u = np.einsum("nij,nkl,nmo->nikmjlo", ua, ub, uc).reshape(pool, DIM, DIM)
    return u @ rho @ np.conj(np.swapaxes(u, -1, -2))


def records(seed, n_units, n_settings, n_shots, pool, coords):
    """The records of units 0 … n_units − 1: effects (n_units,
    n_settings, 64) f32, counts (n_units, n_settings) int32, and the truths'
    coordinates (n_units, 64) f64. ``coords`` maps (…, 8, 8) complex
    matrices to their coordinates (…, 64)."""
    truths = coords(truth_states(seed, pool))
    order = inputs.rng(seed, "truth order")
    idx = np.concatenate([order.permutation(pool)
                          for _ in range(-(-n_units // pool))])[:n_units]
    g = inputs.rng(seed, "records")
    a, b, c = (two_qubit._pure(g, (n_units, n_settings)) for _ in range(3))
    pa, pb, pc = (np.einsum("usi,usj->usij", v, v.conj()) for v in (a, b, c))
    proj = np.einsum("usij,uskl,usmn->usikmjln", pa, pb, pc).reshape(
        n_units, n_settings, DIM, DIM)
    effects = coords(proj).astype(np.float32)
    p1 = np.clip(np.einsum("usk,uk->us", effects.astype(np.float64),
                           truths[idx]), 0.0, 1.0)
    counts = g.binomial(n_shots, p1).astype(np.int32)
    return effects, counts, truths[idx]


class Driver(two_qubit.Driver):
    def __init__(self, cell, seed, device):
        Base.__init__(self, cell, seed, device)
        tr, cfg = self.traffic, self.config
        self.sys = port.build(cfg, tr.get("n_particles"))
        self.ref = cell.module("reference", cfg["reference"])
        self.n_exp = int(cfg["n_settings"])
        self.n_shots = int(cfg["n_shots"])
        self.max_units = int(tr["max_units"])
        self.n_cols = int(cfg["b1_columns"])
        self.d = int(cfg["dimensions"])

        def coords(rho):
            flat = torch.from_numpy(np.ascontiguousarray(
                rho.reshape(-1, DIM, DIM)))
            return self.ref.coords(flat).numpy().reshape(rho.shape[:-2]
                                                         + (self.d,))

        self.effects, self.counts_host, self.truths = records(
            self.seed, self.max_units, self.n_exp, self.n_shots,
            int(tr["truth_pool"]), coords)
        self.effects_dev = torch.as_tensor(self.effects, device=self.device)
        self.counts_dev = torch.as_tensor(self.counts_host,
                                          device=self.device)
        self.n_meas = torch.full((self.n_exp,), self.n_shots,
                                 dtype=torch.int32, device=self.device)
        span_ = int(tr["check_span_units"])
        self.check_steps = set(inputs.sample(
            self.seed, span_ * self.n_exp, int(tr["check_steps"]), "steps"))
        self.check_units = set(inputs.sample(
            self.seed, span_, int(tr["check_units"]), "banks"))
        self.check_resamples = int(tr["check_resamples"])
        self._reset()

    def _unit(self, i, sampled, whole):
        """Unit ``i``'s record, cut at the steps ``sampled`` (indices within
        the record) and, with ``whole``, at every step until
        ``check_resamples`` steps have resampled; keeps those steps and,
        where any step was kept, the final bank. Returns the answer's row:
        the mean (64), the trace of the covariance, the log evidence, the
        resamples."""
        from qinfer_tpu_torch import smc

        s = self.sys
        u = i % self.max_units
        effects, counts = self.effects_dev[u], self.counts_dev[u]
        want = self.check_resamples if whole else 0
        bounds = sorted({0, self.n_exp} | sampled | {j + 1 for j in sampled})
        trail = []
        with span("bank"):
            state = smc.init_smc_state(self.generator("bank", i), s.model,
                                       s.n_particles, s.prior)
        with span("update"):
            log_norms = []
            a = 0
            for b in bounds[1:]:
                while a < b:
                    end = a + 1 if want else b
                    before = state
                    state, ln = smc.smc_batch_update(
                        s.model, s.resampler, s.smc_config, state,
                        counts[a:end], {"meas": effects[a:end],
                                        "n_meas": self.n_meas[a:end]})
                    log_norms.append(ln)
                    keep = a in sampled
                    if want and not keep and bool(state.just_resampled):
                        keep, want = True, want - 1
                    if keep:
                        trail.append({
                            "sampled": a in sampled, "unit": i, "step": a,
                            "locs": before.particle_locations,
                            "log_w": before.particle_log_weights,
                            "after_locs": state.particle_locations,
                            "after_log_w": state.particle_log_weights,
                            "log_norm": ln[0],
                            "resampled": state.just_resampled})
                    a = end
        with span("answer"):
            x = state.particle_locations.to(two_qubit.F64)
            w = torch.softmax(state.particle_log_weights.to(two_qubit.F64),
                              0)
            mean = w @ x
            tr_cov = w @ ((x - mean) ** 2).sum(1)
            row = torch.cat([mean, torch.stack([
                tr_cov, torch.cat(log_norms).to(two_qubit.F64).sum(),
                state.n_resamples.to(two_qubit.F64)])]).cpu().numpy()
        if trail:
            flags = torch.stack([st["resampled"] for st in trail]).tolist()
            for st, flag in zip(trail, flags):
                st["resampled"] = bool(flag)
            self.kept += trail
            self.finals.append(state.particle_locations)
        return row

    def setup(self):
        # One warm unit that keeps as many states as a checked one, so that
        # the allocator holds their memory before the clock starts.
        self._unit(0, set(range(int(self.traffic["check_steps"]))), True)
        self.sync()
        self._reset()
