"""Prior distributions and the weighted particle cloud.

Counterpart of ``qinfer_tpu/distributions.py`` — ``Distribution``,
``UniformDistribution``, ``ConstantDistribution`` (a fixed truth prior),
``PostselectedDistribution`` and the part of ``ParticleDistribution`` that
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

__all__ = ["Distribution", "UniformDistribution", "ConstantDistribution",
           "PostselectedDistribution", "ParticleDistribution"]


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


@dataclass(frozen=True, eq=False)
class ConstantDistribution(Distribution):
    """Dirac delta at ``values``."""

    values: Tuple[float, ...]

    def __init__(self, values):
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
        object.__setattr__(self, "values", tuple(map(float, arr)))

    @property
    def n_rvs(self):
        return len(self.values)

    def sample(self, generator, n: int = 1):
        v = torch.tensor(self.values, dtype=torch.float32,
                         device=generator.device)
        return v[None, :].expand(n, self.n_rvs).clone()


@dataclass(frozen=True, eq=False)
class PostselectedDistribution(Distribution):
    """Samples of ``dist`` that ``model.are_models_valid`` accepts: the
    invalid rows are redrawn for ``maxiters`` rounds, and what is still
    invalid is clamped by ``model.canonicalize``. The rounds run without a
    host read."""

    dist: Distribution
    model: object
    maxiters: int = 100

    @property
    def n_rvs(self):
        return self.dist.n_rvs

    def sample(self, generator, n: int = 1):
        samples = self.dist.sample(generator, n)
        ok = self.model.are_models_valid(samples)
        for _ in range(self.maxiters):
            fresh = self.dist.sample(generator, n)
            valid = self.model.are_models_valid(fresh)
            samples = torch.where((~ok & valid)[:, None], fresh, samples)
            ok = ok | valid
        if hasattr(self.model, "canonicalize"):
            samples = torch.where(ok[:, None], samples,
                                  self.model.canonicalize(samples))
        return samples


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
