"""Prior distributions and the weighted particle cloud.

Counterpart of ``qinfer_tpu/distributions.py`` — ``Distribution``,
``UniformDistribution`` and the part of ``ParticleDistribution`` that
``SMCUpdater`` inherits. ``sample`` takes an explicit ``torch.Generator``
(which fixes the device) where the JAX package takes a key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .utils import (
    effective_sample_size,
    normalize_log_weights,
    particle_covariance_mtx,
    particle_mean,
)

__all__ = ["Distribution", "UniformDistribution", "ParticleDistribution"]


class Distribution:
    """ABC: ``n_rvs`` and ``sample(generator, n) -> (n, n_rvs)`` f32 tensor
    on the generator's device."""

    @property
    def n_rvs(self) -> int:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, n: int = 1):
        raise NotImplementedError


@dataclass(frozen=True, eq=False)
class UniformDistribution(Distribution):
    """Uniform over a box given by ``ranges`` of shape (d, 2) [or (2,)]."""

    ranges: Tuple[Tuple[float, float], ...]

    def __init__(self, ranges):
        arr = np.asarray(ranges, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        object.__setattr__(
            self, "ranges", tuple(tuple(map(float, r)) for r in arr)
        )

    @property
    def n_rvs(self):
        return len(self.ranges)

    def sample(self, generator, n: int = 1):
        device = generator.device
        lo = torch.tensor([r[0] for r in self.ranges], dtype=torch.float32,
                          device=device)
        hi = torch.tensor([r[1] for r in self.ranges], dtype=torch.float32,
                          device=device)
        u = torch.rand((n, self.n_rvs), generator=generator, device=device)
        return lo + u * (hi - lo)


class ParticleDistribution(Distribution):
    """A weighted particle cloud ``(particle_locations,
    particle_log_weights)`` with moment helpers."""

    def __init__(self, particle_locations, particle_weights=None,
                 log_weights=None):
        self.particle_locations = torch.as_tensor(particle_locations,
                                                  dtype=torch.float32)
        n = self.particle_locations.shape[0]
        device = self.particle_locations.device
        if log_weights is not None:
            self.particle_log_weights = torch.as_tensor(
                log_weights, dtype=torch.float32, device=device)
        elif particle_weights is not None:
            self.particle_log_weights = torch.log(torch.as_tensor(
                particle_weights, dtype=torch.float32, device=device))
        else:
            self.particle_log_weights = torch.full(
                (n,), -float(np.log(n)), dtype=torch.float32, device=device)

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def particle_weights(self):
        return torch.exp(normalize_log_weights(self.particle_log_weights)[0])

    def sample(self, generator, n: int = 1):
        idx = torch.multinomial(self.particle_weights, n, replacement=True,
                                generator=generator)
        return self.particle_locations[idx]

    def est_mean(self):
        return particle_mean(self.particle_weights, self.particle_locations)

    def est_covariance_mtx(self, corr=False):
        cov = particle_covariance_mtx(self.particle_weights,
                                      self.particle_locations)
        if corr:
            std = torch.sqrt(torch.diag(cov))
            cov = cov / torch.outer(std, std)
        return cov

    @property
    def n_ess(self):
        """ESS = 1/Σwᵢ² (a property, as in the reference)."""
        return effective_sample_size(self.particle_log_weights)
