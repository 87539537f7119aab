"""Plain reference of ``tomography_3q``: three-qubit state tomography from
binomial counts (QInfer's ``BinomialModel(TomographyModel(pauli_basis(3)))``
with a Ginibre prior and Liu–West resampling; arXiv:1610.00336, "State and
process tomography"), step by step from a bank of particles. It is
``tomography_2q.py`` at d = 8.

A particle is the coordinate vector x (64,) of ρ = Σ x_k B_k in the
normalised Pauli basis B = (P_a ⊗ P_b ⊗ P_c)/√8, P ∈ (I, X, Y, Z), first
qubit slowest (index 16a + 4b + c), so x₀ = Tr ρ/√8. Here:

- the Born rule Pr(1 | x, e) = clip(x·e, 0, 1) for an effect e (64,);
- the update of the weights by k counts of '1' in n shots, Pr(k) =
  C(n, k)·p^k·(1 − p)^(n−k), and the step's log evidence log Σ w·Pr(k);
- the Liu–West resample: parents by systematic resampling, each new
  particle a·x + (1 − a)·μ + h·Σ^{1/2}·ε with h = √(1 − a²), a redraw of
  every particle that is not a state, at most ``maxiter`` rounds, then
  the projection of each one left onto the states;
- validity, from ρ built as an 8 × 8 complex matrix and its eigenvalues by
  ``torch.linalg.eigvalsh`` (in chunks of 2^14 matrices): eigenvalues ≥
  −psd_tol and |Tr ρ − 1| ≤ trace_tol.

Departures from QInfer, each also the system's:

- QInfer redraws one particle at a time until it is a state; here every
  round draws the noise of the whole bank and keeps a fresh draw for each
  particle that is still invalid and whose fresh draw is a state (the
  same law for each particle), at most ``maxiter`` rounds, and projects
  the particles left (QInfer has no bound);
- the parents come from systematic resampling (QInfer's default draws
  them by a multinomial).

Plain PyTorch in ``dtype`` (float64 for the reference), but validity and
the projection, which are always float64; TF32 is off. Imports nothing of
the system under test; the repository's tests import this file as it is.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
C128 = torch.complex128
NQ = 3
DIM = 2 ** NQ
N_EL = DIM * DIM
# Batched eigensolvers take at most this many matrices a call (cuSOLVER's
# batched syevj refuses 65536).
CHUNK = 1 << 14

_PAULI = ([[1, 0], [0, 1]], [[0, 1], [1, 0]], [[0, -1j], [1j, 0]],
          [[1, 0], [0, -1]])


def basis(device="cpu"):
    """(64, 8, 8) complex128: (P_a ⊗ P_b ⊗ P_c)/√8, index 16a + 4b + c."""
    p = torch.tensor(_PAULI, dtype=C128, device=device)
    b = torch.einsum("aij,bkl,cmn->abcikmjln", p, p, p)
    return b.reshape(N_EL, DIM, DIM) / math.sqrt(DIM)


def density(x):
    """ρ (N, 8, 8) complex128 of coordinates x (N, 64)."""
    b = basis(x.device)
    return torch.einsum("nk,kij->nij", x.to(F64).to(C128), b)


def coords(rho):
    """Coordinates (N, 64) float64 of ρ (N, 8, 8): x_k = Re Tr(B_k ρ)."""
    b = basis(rho.device)
    return torch.einsum("kji,nij->nk", b, rho.to(C128)).real


def pr1(locs, effect, dtype=F64):
    """(N,) Pr(1) of every particle under one effect (64,)."""
    return torch.clamp(locs.to(dtype) @ effect.to(dtype), 0.0, 1.0)


def _weights(log_w, dtype):
    lw = log_w.to(dtype)
    return torch.exp(lw - torch.logsumexp(lw, 0))


def update(locs, log_w, effect, shots, k, dtype=F64):
    """The normalised weights after ``k`` counts of '1' in ``shots``
    under ``effect``, and the step's log evidence log Σ w·Pr(k)."""
    log_c = (math.lgamma(shots + 1.0) - math.lgamma(k + 1.0)
             - math.lgamma(shots - k + 1.0))
    w = _weights(log_w, dtype)
    p = pr1(locs, effect, dtype)
    log_lik = (log_c + torch.xlogy(float(k), p)
               + torch.xlogy(float(shots - k), 1.0 - p))
    lw = torch.log(w) + log_lik
    log_z = torch.logsumexp(lw, 0)
    return torch.exp(lw - log_z), log_z


def lowest_eigenvalues(x):
    """(N,) the lowest eigenvalue of each ρ, float64, in chunks."""
    parts = [torch.linalg.eigvalsh(density(c))[:, 0]
             for c in x.split(CHUNK)]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=F64,
                                                      device=x.device)


def invalid_rows(x, psd_tol, trace_tol):
    """(N,) bool: the particles that are not states."""
    x = x.to(F64)
    trace = math.sqrt(DIM) * x[:, 0]
    return ((lowest_eigenvalues(x) < -psd_tol)
            | (torch.abs(trace - 1.0) > trace_tol))


def project(x, psd_tol):
    """The states nearest each particle by their spectrum: ρ's eigenvalues
    floored at ``psd_tol`` and scaled to sum 1, its eigenvectors kept."""
    out = []
    for c in x.split(CHUNK):
        lam, vec = torch.linalg.eigh(density(c))
        lam = torch.clamp(lam, min=psd_tol)
        lam = lam / lam.sum(-1, keepdim=True)
        out.append(coords((vec * lam[:, None, :].to(C128)) @ vec.mH))
    return torch.cat(out) if out else x.to(F64)


def liu_west(locs, w, a, maxiter, psd_tol, trace_tol, generator, dtype=F64,
             u0=None, noise=None):
    """The Liu–West resample of the bank ``locs`` (N, 64) under the
    normalised weights ``w``, in ``dtype`` (Σ^{1/2}, validity and the
    projection in float64). ``u0`` (the systematic offset) and ``noise``
    (a function of the shape that gives the standard normal draws of one
    round) come from ``generator`` unless given."""
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
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=dev, dtype=F64)
    strata = ((u0 + torch.arange(n, device=dev, dtype=F64)) / n).to(dtype)
    parent = torch.clamp(torch.searchsorted(cdf, strata * cdf[-1]), max=n - 1)
    centres = a * x[parent] + (1.0 - a) * mu

    def draw():
        if noise is not None:
            return noise((n, d)).to(dtype)
        return torch.randn((n, d), generator=generator, device=dev,
                           dtype=F64).to(dtype)

    new = centres + draw() @ root.T
    bad = invalid_rows(new, psd_tol, trace_tol)
    for _ in range(maxiter):
        if not bool(bad.any()):
            break
        eps = draw()
        rows = torch.nonzero(bad).squeeze(1)
        fresh = centres[rows] + eps[rows] @ root.T
        good = ~invalid_rows(fresh, psd_tol, trace_tol)
        new[rows[good]] = fresh[good]
        bad[rows[good]] = False
    if bool(bad.any()):
        new[bad] = project(new[bad], psd_tol).to(dtype)
    return new


def moment_gaps(locs, log_w, ref_locs):
    """How far the weighted bank ``locs`` lies from the reference's
    resampled bank ``ref_locs`` (equal weights), each gap in standard
    errors of the difference of two banks of n draws: the widest over
    the 63 coordinates that move of the means' gap, over σᵢ·√(2/n), and
    over their 2016 covariances (i ≤ j) of the covariances' gap, over
    2·σᵢσⱼ/√n. x₀ = Tr ρ/√8 does not move: its spread is the rounding of
    the stored values, so it is left out."""
    x = locs.to(F64)
    y = ref_locs.to(F64)
    n = y.shape[0]
    w = _weights(log_w, F64)
    mx, my = w @ x, y.mean(0)
    cx = ((x - mx) * w[:, None]).T @ (x - mx)
    cy = (y - my).T @ (y - my) / n
    sd = torch.sqrt(torch.diagonal(cy)[1:])
    mean_z = torch.abs(mx - my)[1:] / (sd * math.sqrt(2.0 / n))
    cov_z = torch.abs(cx - cy)[1:, 1:] / (
        2.0 * torch.outer(sd, sd) / math.sqrt(n))
    return float(mean_z.max()), float(cov_z.max())


def invalid(locs, psd_tol, trace_tol):
    """How many particles of ``locs`` are not states (computed in float64
    from the stored values)."""
    return int(invalid_rows(locs, psd_tol, trace_tol).sum())
