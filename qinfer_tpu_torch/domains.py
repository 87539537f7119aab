"""Outcome domains. Counterpart of ``qinfer_tpu/domains.py``: ``Domain``,
``RealDomain``, ``IntegerDomain`` and ``MultinomialDomain``.

Domains are frozen dataclasses of static metadata. ``values`` enumerates
a finite domain on the host with NumPy, in the JAX package's order, and
returns a CPU tensor (callers move it to the bank's device);
``in_domain`` works on the device of its argument.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import comb

import numpy as np
import torch

__all__ = ["Domain", "RealDomain", "IntegerDomain", "MultinomialDomain"]


@dataclass(frozen=True)
class Domain:
    """Abstract outcome domain."""

    @property
    def is_continuous(self) -> bool:
        raise NotImplementedError

    @property
    def is_finite(self) -> bool:
        raise NotImplementedError

    @property
    def n_members(self):
        """Number of members, or None if infinite."""
        return None

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def values(self):
        """Enumerated members (finite domains only)."""
        raise NotImplementedError

    def in_domain(self, points):
        """Boolean mask of membership."""
        raise NotImplementedError


@dataclass(frozen=True)
class RealDomain(Domain):
    """Reals in [min, max] (either bound may be None: unbounded)."""

    min: float | None = None
    max: float | None = None

    @property
    def is_continuous(self):
        return True

    @property
    def is_finite(self):
        return False

    @property
    def dtype(self):
        return torch.float32

    def in_domain(self, points):
        points = torch.as_tensor(points)
        ok = torch.ones(points.shape, dtype=torch.bool, device=points.device)
        if self.min is not None:
            ok = ok & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok


@dataclass(frozen=True)
class IntegerDomain(Domain):
    """Integers in [min, max] (max None: unbounded above)."""

    min: int = 0
    max: int | None = None

    @property
    def is_continuous(self):
        return False

    @property
    def is_finite(self):
        return self.max is not None

    @property
    def n_members(self):
        if self.max is None:
            return None
        return self.max - self.min + 1

    @property
    def dtype(self):
        return torch.int32

    @property
    def values(self):
        if self.max is None:
            raise ValueError("Cannot enumerate an unbounded IntegerDomain.")
        return torch.arange(self.min, self.max + 1, dtype=torch.int32)

    def in_domain(self, points):
        points = torch.as_tensor(points)
        ok = (points == torch.round(points)) & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok


def _compositions(n, k):
    """The compositions of n into k non-negative parts, the first part
    slowest-varying (the JAX package's order)."""
    if k == 1:
        yield (n,)
        return
    for head in range(n + 1):
        for rest in _compositions(n - head, k - 1):
            yield (head,) + rest


@dataclass(frozen=True)
class MultinomialDomain(Domain):
    """Tuples of ``n_elements`` non-negative integers summing to ``n_meas``;
    members are (..., n_elements) integer arrays."""

    n_meas: int = 1
    n_elements: int = 2

    @property
    def is_continuous(self):
        return False

    @property
    def is_finite(self):
        return True

    @property
    def n_members(self):
        return comb(self.n_meas + self.n_elements - 1, self.n_elements - 1)

    @property
    def dtype(self):
        return torch.int32

    @property
    def values(self):
        """Every composition of n_meas into n_elements parts, (n_members,
        n_elements) int32."""
        rows = np.array(list(_compositions(self.n_meas, self.n_elements)),
                        dtype=np.int32)
        return torch.from_numpy(rows)

    def in_domain(self, points):
        points = torch.as_tensor(points)
        ok = torch.all(points >= 0, dim=-1)
        return ok & (torch.sum(points, dim=-1) == self.n_meas)

    def to_regular_array(self, a):
        """Identity: outcomes are plain (..., k) integer tensors already."""
        return torch.as_tensor(a)

    def from_regular_array(self, a):
        return torch.as_tensor(a)
