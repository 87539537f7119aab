"""Weighted-particle numerics on torch tensors.

Counterpart of ``qinfer_tpu/utils.py`` (the part the ported paths use:
the binomial pmfs, ``normalize_log_weights`` … ``sqrtm_psd`` and
``pytree_to_expparams``) and ``eigh_batched``. Every function works on the
device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "log_binomial_coefficient",
    "log_binomial_pdf",
    "binomial_pdf",
    "normalize_log_weights",
    "log_effective_sample_size",
    "effective_sample_size",
    "particle_mean",
    "particle_covariance_mtx",
    "weighted_moments",
    "weighted_moments_batched",
    "sqrtm_psd",
    "eigh_batched",
    "cumsum_rows",
    "pytree_to_expparams",
]

# cuSOLVER's batched syev (torch 2.11, CUDA 12.8, on an H100) refuses a
# batch of 65536 matrices with CUSOLVER_STATUS_INVALID_VALUE, for every
# size and dtype tried (4, 8, 16; f32, f64); 16384 works.
_EIGH_MAX_BATCH = 1 << 14


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def log_binomial_coefficient(n, k):
    """log C(n, k) via lgamma."""
    n, k = _f32(n), _f32(k)
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0))


def log_binomial_pdf(n, k, p):
    """log Pr(k | n, p) for a binomial.

    xlogy/xlog1py give the limits at p ∈ {0, 1} (0·log 0 = 0); impossible
    outcomes come back as −inf, which the SMC engine clips. Where a
    prefactor is zero its operand is replaced by a harmless one, as the
    JAX package does for finite gradients: the values are unchanged.
    """
    n, k, p = _f32(n), _f32(k), _f32(p)
    p_k = torch.where(k == 0.0, 1.0, p)
    mp_nk = torch.where(n - k == 0.0, 0.0, -p)
    return (log_binomial_coefficient(n, k) + torch.xlogy(k, p_k)
            + torch.special.xlog1py(n - k, mp_nk))


def binomial_pdf(n, k, p):
    """Pr(k | n, p)."""
    return torch.exp(log_binomial_pdf(n, k, p))


def normalize_log_weights(log_w):
    """Normalize so logsumexp(log_w) == 0. Returns (normalized, logsumexp)."""
    lse = torch.logsumexp(log_w, dim=0)
    return log_w - lse, lse


def log_effective_sample_size(log_w):
    """log ESS = −logsumexp(2 · normalized log_w)."""
    log_w_norm, _ = normalize_log_weights(log_w)
    return -torch.logsumexp(2.0 * log_w_norm, dim=0)


def effective_sample_size(log_w):
    return torch.exp(log_effective_sample_size(log_w))


def particle_mean(weights, locations):
    return weights @ locations


def particle_covariance_mtx(weights, locations):
    """Weighted covariance Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ in the centered two-pass
    form: E[xxᵀ] − μμᵀ cancels to negative variances in f32 once the
    posterior is ~1e-3 of the mean scale."""
    mu = particle_mean(weights, locations)
    centered = locations - mu[None, :]
    cov = torch.einsum("i,id,ie->de", weights, centered, centered)
    return 0.5 * (cov + cov.T)


def weighted_moments(log_w, locations):
    """(mean, cov) from log-weights, centered for f32 stability."""
    w = torch.exp(normalize_log_weights(log_w)[0])
    mu = particle_mean(w, locations)
    centered = locations - mu[None, :]
    cov = torch.einsum("i,id,ie->de", w, centered, centered)
    return mu, 0.5 * (cov + cov.T)


def weighted_moments_batched(log_w, locations):
    """(mean (T, D), cov (T, D, D)) of T banks: ``log_w`` (T, N),
    ``locations`` (T, N, D); centered, as ``weighted_moments``."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=1, keepdim=True))
    mu = torch.einsum("tn,tnd->td", w, locations)
    centered = locations - mu[:, None, :]
    cov = torch.einsum("tn,tnd,tne->tde", w, centered, centered)
    return mu, 0.5 * (cov + cov.transpose(1, 2))


def sqrtm_psd(mat, est_error=False):
    """Symmetric PSD square root via eigh, clipping negative eigenvalues;
    ``mat`` is (D, D) or a batch (…, D, D)."""
    vals, vecs = eigh_batched(mat)
    vals_c = torch.clamp(vals, min=0.0)
    root = (vecs * torch.sqrt(vals_c)[..., None, :]) @ vecs.transpose(-1, -2)
    if est_error:
        return root, torch.sum(torch.abs(vals - vals_c), dim=-1)
    return root


def eigh_batched(mat):
    """``torch.linalg.eigh`` of (…, m, m) symmetric matrices, taken in
    chunks of at most 2^14 matrices (each matrix's result is its own)."""
    lead, m = mat.shape[:-2], mat.shape[-1]
    flat = mat.reshape(-1, m, m)
    if flat.shape[0] <= _EIGH_MAX_BATCH:
        return torch.linalg.eigh(mat)
    parts = [torch.linalg.eigh(chunk)
             for chunk in flat.split(_EIGH_MAX_BATCH)]
    evals = torch.cat([p[0] for p in parts])
    evecs = torch.cat([p[1] for p in parts])
    return evals.reshape(lead + (m,)), evecs.reshape(lead + (m, m))


def cumsum_rows(x):
    """Inclusive cumsum of each row of an integer (T, N) tensor, exact.

    One scan over the flattened rows, less each row's start. torch's scan
    along the last axis of a (T, N) tensor gives each row one block, which
    for a few long rows is slow (0.3–0.4 ms a call for 4 rows of 2^18 on
    an H100, ``chip_profile.py``)."""
    flat = torch.cumsum(x.reshape(-1), dim=0).reshape(x.shape)
    before = torch.cat([torch.zeros(1, dtype=flat.dtype, device=flat.device),
                        flat[:-1, -1]])
    return flat - before[:, None]


def pytree_to_expparams(record_array):
    """NumPy record array → expparams (dict of named tensors)."""
    return {name: torch.from_numpy(np.ascontiguousarray(record_array[name]))
            for name in record_array.dtype.names}
