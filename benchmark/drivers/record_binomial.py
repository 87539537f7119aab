"""Driver ``record_binomial``: fixed records of binomial counts through
``smc_batch_update``, for two-qubit tomography.

A unit is one record of the configuration's ``n_settings`` product
projectors |a⟩⟨a| ⊗ |b⟩⟨b| (a and b normalised complex Gaussians), each
with ``n_shots`` shots whose count of '1' is drawn from the seed at the
unit's true state, run through ``smc.smc_batch_update`` from a fresh bank
of the configuration's particles drawn on the card from the seed. The
true states are a pool of ``truth_pool``: the source's
0.9|Φ⁺⟩⟨Φ⁺| + 0.1·I/4 under local unitaries U_a ⊗ U_b drawn from the seed
(Haar), so that every truth has the same spectrum; each block of
``truth_pool`` consecutive units holds every truth once, in an order drawn
from the seed. The user's answer is the posterior's mean (16 coordinates),
the trace of its covariance and the record's log evidence, read on the
host when the unit ends.

``correct`` follows the program step by step from its own state, at a
sample of the steps of the window's first ``check_span_units`` units drawn
from the seed. On a sampled unit the record goes to ``smc_batch_update`` in
consecutive slices cut at the sampled steps (a loop over
``smc_update_step`` with the generator in the state, so the arithmetic is
that of one call), and every step of the ``check_units`` units drawn from
the seed is such a cut. The plain reference recomputes, in float64 from
the bank before the step, the weights after the update (on steps that did
not resample) and the step's log evidence. At every step that resampled
in those units it updates the bank before the step and resamples it by
Liu–West itself, with draws of its own: the program's resampled bank must
have the reference's mean and covariance, to within the Monte-Carlo error
of two banks of that size. Every resampled bank checked, and the final
bank of every sampled unit, must hold states only.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import compare, inputs, port, roofline
from harness.driver import Base, span

F64 = torch.float64


def _pure(rng, shape):
    """Normalised complex Gaussian 2-vectors, ``shape`` + (2,)."""
    v = rng.standard_normal(shape + (2,)) + 1j * rng.standard_normal(
        shape + (2,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _haar(rng, n):
    """``n`` Haar-random 2 × 2 unitaries."""
    z = (rng.standard_normal((n, 2, 2))
         + 1j * rng.standard_normal((n, 2, 2))) / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    return q * (d / np.abs(d))[:, None, :]


def truth_states(seed, pool):
    """(pool, 4, 4) complex: 0.9|Φ⁺⟩⟨Φ⁺| + 0.1·I/4 under U_a ⊗ U_b."""
    phi = np.zeros(4, complex)
    phi[0] = phi[3] = 1.0 / np.sqrt(2.0)
    rho = 0.9 * np.outer(phi, phi.conj()) + 0.1 * np.eye(4) / 4.0
    g = inputs.rng(seed, "truth pool")
    u = np.einsum("nij,nkl->nikjl", _haar(g, pool), _haar(g, pool)).reshape(
        pool, 4, 4)
    return u @ rho @ np.conj(np.swapaxes(u, -1, -2))


def records(seed, n_units, n_settings, n_shots, pool, coords):
    """The records of units 0 … n_units − 1: effects (n_units,
    n_settings, 16) f32, counts (n_units, n_settings) int32, and the truths'
    coordinates (n_units, 16) f64. ``coords`` maps (…, 4, 4) complex
    matrices to their coordinates (…, 16)."""
    truths = coords(truth_states(seed, pool))
    order = inputs.rng(seed, "truth order")
    idx = np.concatenate([order.permutation(pool)
                          for _ in range(-(-n_units // pool))])[:n_units]
    g = inputs.rng(seed, "records")
    a = _pure(g, (n_units, n_settings))
    b = _pure(g, (n_units, n_settings))
    pa = np.einsum("usi,usj->usij", a, a.conj())
    pb = np.einsum("usi,usj->usij", b, b.conj())
    proj = np.einsum("usij,uskl->usikjl", pa, pb).reshape(
        n_units, n_settings, 4, 4)
    effects = coords(proj).astype(np.float32)
    p1 = np.clip(np.einsum("usk,uk->us", effects.astype(np.float64),
                           truths[idx]), 0.0, 1.0)
    counts = g.binomial(n_shots, p1).astype(np.int32)
    return effects, counts, truths[idx]


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        tr, cfg = self.traffic, self.config
        self.sys = port.build(cfg, tr.get("n_particles"))
        self.ref = cell.module("reference", cfg["reference"])
        self.n_exp = int(cfg["n_settings"])
        self.n_shots = int(cfg["n_shots"])
        self.max_units = int(tr["max_units"])

        def coords(rho):
            flat = torch.from_numpy(np.ascontiguousarray(rho.reshape(-1, 4,
                                                                     4)))
            return self.ref.coords(flat).numpy().reshape(rho.shape[:-2]
                                                         + (16,))

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
        self.n_cols = int(cfg["b1_columns"])
        self.d = int(cfg["dimensions"])
        self._reset()

    def _reset(self):
        self.kept = []
        self.finals = []
        self.answers = []
        self.count.clear()

    def _unit(self, i, sampled, whole):
        """Unit ``i``'s record, cut at the steps ``sampled`` (indices within
        the record) and, with ``whole``, at every step; keeps the sampled
        steps, every step that resampled in a ``whole`` unit and, where any
        step was kept, the final bank. Returns the answer's row: the mean
        (16), the trace of the covariance, the log evidence, the
        resamples."""
        from qinfer_tpu_torch import smc

        s = self.sys
        u = i % self.max_units
        effects, counts = self.effects_dev[u], self.counts_dev[u]
        cut = set(range(self.n_exp)) if whole else sampled
        bounds = sorted({0, self.n_exp} | cut | {j + 1 for j in cut})
        trail = []
        with span("bank"):
            state = smc.init_smc_state(self.generator("bank", i), s.model,
                                       s.n_particles, s.prior)
        with span("update"):
            log_norms = []
            for a, b in zip(bounds, bounds[1:]):
                before = state
                state, ln = smc.smc_batch_update(
                    s.model, s.resampler, s.smc_config, state, counts[a:b],
                    {"meas": effects[a:b], "n_meas": self.n_meas[a:b]})
                log_norms.append(ln)
                if a in cut:
                    trail.append({
                        "sampled": a in sampled, "unit": i, "step": a,
                        "locs": before.particle_locations,
                        "log_w": before.particle_log_weights,
                        "after_locs": state.particle_locations,
                        "after_log_w": state.particle_log_weights,
                        "log_norm": ln[0], "resampled": state.just_resampled})
        with span("answer"):
            x = state.particle_locations.to(F64)
            w = torch.softmax(state.particle_log_weights.to(F64), 0)
            mean = w @ x
            tr_cov = w @ ((x - mean) ** 2).sum(1)
            row = torch.cat([mean, torch.stack([
                tr_cov, torch.cat(log_norms).to(F64).sum(),
                state.n_resamples.to(F64)])]).cpu().numpy()
        if trail:
            flags = torch.stack([st["resampled"] for st in trail]).tolist()
            for st, flag in zip(trail, flags):
                st["resampled"] = bool(flag)
            self.kept += [st for st in trail
                          if st["sampled"] or st["resampled"]]
            self.finals.append(state.particle_locations)
        return row

    def _sampled(self, i):
        return {j - i * self.n_exp for j in self.check_steps
                if i * self.n_exp <= j < (i + 1) * self.n_exp}

    def setup(self):
        # One warm unit that keeps as many states as a checked one, so that
        # the allocator holds their memory before the clock starts.
        self._unit(0, set(range(self.n_exp)), True)
        self.sync()
        self._reset()

    def unit(self, i):
        row = self._unit(i, self._sampled(i), i in self.check_units)
        self.answers.append(row)
        n = self.sys.n_particles
        res = int(row[-1])
        self.count["steps"] += self.n_exp
        self.count["updates"] += self.n_exp
        self.count["resamples"] += res
        self.count["b1_bytes"] += self.n_exp * roofline.b1_bytes(n,
                                                                 self.n_cols)
        self.count["b2_bytes"] += res * roofline.b2_bytes(n, n, self.d)
        return {"work": n * self.n_exp, "steps": self.n_exp}

    def release(self):
        self.sys = None

    def check(self, control=False):
        """The gaps of the kept steps from the plain reference (float64);
        with ``control``, of the reference's own numbers computed in
        bfloat16 in the program's place."""
        ref = self.ref
        lim = self.traffic["limits"]
        g = self.config["guarantees"]
        lw = self.config["resampler"]["kwargs"]
        psd = g["psd_tol"] + g["f32_slack"]
        trace = g["trace_tol"] + g["f32_slack"]
        low = torch.bfloat16
        upd, ev, mean_z, cov_z, bad = [], [], [], [], []
        for st in self.kept:
            u = st["unit"] % self.max_units
            effect = self.effects_dev[u, st["step"]]
            k = int(self.counts_host[u, st["step"]])
            w_ref, ln_ref = ref.update(st["locs"], st["log_w"], effect,
                                       self.n_shots, k, F64)
            if control:
                w, ln = ref.update(st["locs"], st["log_w"], effect,
                                   self.n_shots, k, low)
            else:
                w, ln = torch.exp(st["after_log_w"].to(F64)), st["log_norm"]
            ev.append(abs(float(ln) - float(ln_ref)))
            if not st["resampled"]:
                upd.append(float(torch.max(torch.abs(w.to(F64) - w_ref))
                                 / torch.max(w_ref)))
                continue
            gen = self.generator("resample", st["unit"], st["step"])
            args = (lw["a"], lw["maxiter"], g["psd_tol"], g["trace_tol"])
            ref_locs = ref.liu_west(st["locs"], w_ref, *args, gen, F64)
            if control:
                after = ref.liu_west(st["locs"], w_ref, *args, gen, low)
                after_log_w = torch.zeros(after.shape[0], device=after.device)
            else:
                after, after_log_w = st["after_locs"], st["after_log_w"]
            mz, cz = ref.moment_gaps(after, after_log_w, ref_locs)
            mean_z.append(mz)
            cov_z.append(cz)
            bad.append(ref.invalid(after, psd, trace))
        if not control:
            bad += [ref.invalid(locs, psd, trace) for locs in self.finals]
        return [compare.worst("update_gap", upd, lim["update_gap"]),
                compare.worst("evidence_gap", ev, lim["evidence_gap"]),
                compare.worst("resample_mean_z", mean_z,
                              lim["resample_mean_z"]),
                compare.worst("resample_cov_z", cov_z, lim["resample_cov_z"]),
                compare.worst("invalid_states", bad, lim["invalid_states"])]
