"""Weighted particle metrics on the host. Counterpart of
``qinfer_tpu/metrics.py``: the pairwise distances that clustering uses,
in NumPy f64 with scikit-learn's ``pairwise_distances`` (imported when
called). Tensors on any device are copied to the host."""

from __future__ import annotations

import numpy as np

__all__ = ["rescaled_distance_mtx", "weighted_pairwise_distances"]


def _host(x):
    """``x`` (a tensor on any device, or array-like) as a NumPy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def rescaled_distance_mtx(locations, weights=None, metric="euclidean"):
    """Pairwise distances of particles whitened by their weighted
    covariance, so that a clustering ``eps`` does not depend on the
    parameters' scales."""
    from sklearn.metrics import pairwise_distances

    locs = _host(locations).astype(float)
    n = locs.shape[0]
    w = np.full(n, 1.0 / n) if weights is None else _host(weights).astype(
        float)
    mu = w @ locs
    centered = locs - mu
    cov = (w[:, None] * centered).T @ centered
    vals, vecs = np.linalg.eigh(cov)
    whitener = vecs @ np.diag(1.0 / np.sqrt(np.clip(vals, 1e-12, None)))
    return pairwise_distances(centered @ whitener, metric=metric)


def weighted_pairwise_distances(locations, weights, metric="euclidean",
                                w_pow=0.5):
    """Whitened distances scaled by (n·√(wᵢwⱼ))^(−w_pow): heavy pairs look
    closer."""
    locs = _host(locations).astype(float)
    w = _host(weights).astype(float)
    n = locs.shape[0]
    base = rescaled_distance_mtx(locs, w, metric=metric)
    return base * (n * np.sqrt(np.outer(w, w))) ** (-w_pow)
