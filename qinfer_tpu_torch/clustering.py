"""Particle clustering on the host. Counterpart of
``qinfer_tpu/clustering.py``: DBSCAN (scikit-learn, imported when called)
over the particle cloud, one (label, mask) pair a cluster, ``NOISE`` for
the particles in none. It runs once per analysis query, not per update;
tensors on any device are copied to the host."""

from __future__ import annotations

import warnings

import numpy as np

from .metrics import _host

__all__ = ["particle_clusters", "NOISE"]

NOISE = -1


def particle_clusters(particle_locations, particle_weights=None, eps=0.5,
                      min_particles=5, metric="euclidean", weighted=False,
                      w_pow=0.5, quiet=True):
    """Yield (cluster label, member mask) pairs from DBSCAN, in label
    order. ``weighted=True`` clusters on ``weighted_pairwise_distances``
    (heavy particles cluster more readily)."""
    from sklearn.cluster import DBSCAN

    locs = _host(particle_locations)
    n = locs.shape[0]
    w = (np.full(n, 1.0 / n) if particle_weights is None
         else _host(particle_weights))
    if weighted:
        from .metrics import weighted_pairwise_distances

        labels = DBSCAN(eps=eps, min_samples=min_particles,
                        metric="precomputed").fit_predict(
            weighted_pairwise_distances(locs, w, metric=metric, w_pow=w_pow))
    else:
        labels = DBSCAN(eps=eps, min_samples=min_particles,
                        metric=metric).fit_predict(locs)
    found = set(int(label) for label in labels)
    if not quiet and NOISE in found:
        warnings.warn(f"{int((labels == NOISE).sum())} particles labeled as "
                      "noise.")
    for label in sorted(found):
        yield label, labels == label
