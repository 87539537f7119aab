"""Plain reference of ``qubit_tomography``: one Bayes update, the expected
information gain of candidate effects, the Liu–West resample with its
postselection, and the validity of qubit states, each from a bank of
particles in the normalised Pauli basis (I, X, Y, Z)/√2,
where x₀ = Tr ρ/√2 and the Born rule is Pr(1 | x, e) = x·e clipped to
[0, 1].

It follows the system step by step from the system's own state (the bank
before a step): the update of the weights, the log evidence of the step
and the information gain are recomputed here from the particles and
weights alone, in ``dtype`` (float64 for the reference). Plain PyTorch;
imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def _weights(log_w, dtype):
    lw = log_w.to(dtype)
    return torch.exp(lw - torch.logsumexp(lw, 0))


def born_pr1(locs, effects, dtype):
    """(N, E) Pr(1) of every particle under every effect."""
    return torch.clamp(locs.to(dtype) @ effects.to(dtype).T, 0.0, 1.0)


def update(locs, log_w, effect, outcome, dtype=F64):
    """The normalised weights after observing ``outcome`` under ``effect``
    (d²,), and the step's log evidence log Σ w·L."""
    w = _weights(log_w, dtype)
    p1 = born_pr1(locs, effect.reshape(1, -1), dtype)[:, 0]
    lik = p1 if int(outcome) == 1 else 1.0 - p1
    wl = w * lik
    z = wl.sum()
    return wl / z, torch.log(z)


def _entropy(p):
    q = 1.0 - p
    return -(torch.xlogy(p, p) + torch.xlogy(q, q))


def information_gain(locs, log_w, effects, dtype=F64):
    """(E,) mutual information between the outcome and the state:
    H(Σ w·p) − Σ w·H(p), p = Pr(1) of each particle."""
    w = _weights(log_w, dtype)
    p1 = born_pr1(locs, effects, dtype)
    return _entropy(w @ p1) - w @ _entropy(p1)


def _invalid_rows(x, psd_tol, trace_tol):
    lam_min = (x[:, 0] - torch.linalg.vector_norm(x[:, 1:], dim=1)) \
        / math.sqrt(2.0)
    return (lam_min < -psd_tol) | (torch.abs(x[:, 0] - 1.0 / math.sqrt(2.0))
                                   > trace_tol)


def liu_west(locs, w, a, maxiter, psd_tol, trace_tol, generator,
             dtype=F64):
    """The Liu–West resample of the bank ``locs`` under the normalised
    weights ``w``: parents drawn by systematic resampling, each new
    particle a·x + (1 − a)·μ + √(1 − a²)·Σ^{1/2}·ε with the weighted mean μ
    and covariance Σ; a particle that is not a state is drawn again from
    its parent, at most ``maxiter`` times, and one still invalid is moved
    onto the ball's surface. In ``dtype`` throughout, but Σ^{1/2} of the
    (d², d²) covariance, which comes from ``eigh`` in float64."""
    dev = locs.device
    x = locs.to(dtype)
    w = w.to(dtype)
    w = w / w.sum()
    n, d = x.shape
    mu = w @ x
    dx = x - mu
    cov = (dx * w[:, None]).T @ dx
    lam, vec = torch.linalg.eigh((1.0 - a * a) * cov.to(F64))
    root = ((vec * torch.sqrt(torch.clamp(lam, min=0.0))) @ vec.T).to(dtype)
    cdf = torch.cumsum(w, 0)
    u0 = torch.rand((), generator=generator, device=dev, dtype=F64)
    strata = ((u0 + torch.arange(n, device=dev, dtype=F64)) / n).to(dtype)
    parent = torch.clamp(torch.searchsorted(cdf, strata * cdf[-1]), max=n - 1)
    centres = a * x[parent] + (1.0 - a) * mu

    def draw():
        eps = torch.randn((n, d), generator=generator, device=dev,
                          dtype=F64).to(dtype)
        return centres + eps @ root.T

    new = draw()
    bad = _invalid_rows(new.to(F64), psd_tol, trace_tol)
    for _ in range(maxiter):
        if not bool(bad.any()):
            break
        fresh = draw()
        take = bad & ~_invalid_rows(fresh.to(F64), psd_tol, trace_tol)
        new = torch.where(take[:, None], fresh, new)
        bad = bad & ~take
    if bool(bad.any()):
        y = new[bad].to(F64)
        r = torch.linalg.vector_norm(y[:, 1:], dim=1, keepdim=True)
        y[:, 1:] *= torch.clamp(y[:, :1] / r, max=1.0)
        new[bad] = y.to(dtype)
    return new


def moment_gaps(locs, log_w, ref_locs):
    """How far the weighted bank ``locs`` lies from the reference's
    resampled bank ``ref_locs`` (equal weights), each gap in standard
    errors of the difference of two banks of n draws: the widest over
    the coordinates that move (x₀ does not) of the means' gap, over
    σᵢ·√(2/n), and of the covariances', over 2·σᵢσⱼ/√n."""
    x = locs.to(F64)
    y = ref_locs.to(F64)
    n = y.shape[0]
    w = _weights(log_w, F64)
    mx, my = w @ x, y.mean(0)
    cx = ((x - mx) * w[:, None]).T @ (x - mx)
    cy = (y - my).T @ (y - my) / n
    var = torch.diagonal(cy)
    moves = var > 1e-12 * var.sum()
    sd = torch.sqrt(var[moves])
    mean_z = torch.abs(mx - my)[moves] / (sd * math.sqrt(2.0 / n))
    cov_z = torch.abs(cx - cy)[moves][:, moves] / (
        2.0 * torch.outer(sd, sd) / math.sqrt(n))
    return float(mean_z.max()), float(cov_z.max())


def invalid(locs, psd_tol, trace_tol):
    """How many particles are not a state: ρ's eigenvalues x₀/√2 ±
    ‖x₁…‖/√2 below −``psd_tol`` or |x₀ − 1/√2| above ``trace_tol``
    (computed in float64 from the stored values)."""
    return int(_invalid_rows(locs.to(F64), psd_tol, trace_tol).sum())
