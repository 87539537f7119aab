"""Weighted-particle numerics on torch tensors.

Counterpart of ``qinfer_tpu/utils.py`` (the main path's part:
``normalize_log_weights`` … ``sqrtm_psd``). Every function works on the
device of its inputs.
"""

from __future__ import annotations

import torch

__all__ = [
    "normalize_log_weights",
    "log_effective_sample_size",
    "effective_sample_size",
    "particle_mean",
    "particle_covariance_mtx",
    "weighted_moments",
    "sqrtm_psd",
]


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


def sqrtm_psd(mat, est_error=False):
    """Symmetric PSD square root via eigh, clipping negative eigenvalues."""
    vals, vecs = torch.linalg.eigh(mat)
    vals_c = torch.clamp(vals, min=0.0)
    root = (vecs * torch.sqrt(vals_c)[None, :]) @ vecs.T
    if est_error:
        return root, torch.sum(torch.abs(vals - vals_c))
    return root
