"""The reference's cluster fan-out model over a process group.

Counterpart of ``qinfer_tpu/parallel/direct_view.py``
(``DirectViewParallelizedModel``, the reference's wrapper that scatters
``modelparams`` row blocks over ipyparallel engines and gathers the
likelihoods). Here the engines are the ranks of a ``torch.distributed``
process group: every rank holds the whole ``modelparams``, evaluates its
contiguous row block, and one all-gather returns the full (O, N, E)
likelihood to every rank. The engine itself never needs this class (the
sharded step of ``sharded_smc`` splits the bank for good); it exists so
that code written around the reference's wrapper ports by handing it a
mesh in place of a view.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.derived import DerivedModel
from .mesh import PARTICLE_AXIS

__all__ = ["DirectViewParallelizedModel"]


@dataclass(frozen=True, eq=False)
class DirectViewParallelizedModel(DerivedModel):
    """Split likelihood evaluation over the ranks of a process group.

    ``mesh``: a mesh with a ``particles`` axis (default: the default
    process group, when one is initialised). ``serial_threshold``: particle
    counts at or below it evaluate on each rank whole, as the reference
    skips the scatter for small jobs (its default: 10 × the number of
    ranks). Without a process group, when N does not divide by the number
    of ranks, or at or below the threshold, the model evaluates serially,
    as the reference's view with one engine would.
    ``simulate_experiment`` always delegates serially, so its draws are
    the underlying model's. ``fused_update_supported`` is False: the step
    must call this wrapper's likelihood.
    """

    mesh: object = None
    serial_threshold: int = None

    def _group(self, n):
        """The group to split ``n`` rows over, or None for serial."""
        if self.mesh is not None:
            group = self.mesh.get_group(PARTICLE_AXIS)
        elif dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        else:
            return None
        k = dist.get_world_size(group)
        thresh = (10 * k if self.serial_threshold is None
                  else int(self.serial_threshold))
        return None if n <= thresh or n % k else group

    def _fan_out(self, fn, outcomes, modelparams, expparams):
        modelparams = torch.as_tensor(modelparams)
        n = modelparams.shape[0]
        group = self._group(n)
        if group is None:
            return fn(outcomes, modelparams, expparams)
        k, me = dist.get_world_size(group), dist.get_rank(group)
        size = n // k
        block = fn(outcomes, modelparams[me * size:(me + 1) * size],
                   expparams).contiguous()  # (O, n/K, E)
        parts = [torch.empty_like(block) for _ in range(k)]
        dist.all_gather(parts, block, group=group)
        return torch.cat(parts, dim=1)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self._fan_out(self.underlying_model.log_likelihood, outcomes,
                             modelparams, expparams)

    def likelihood(self, outcomes, modelparams, expparams):
        return self._fan_out(self.underlying_model.likelihood, outcomes,
                             modelparams, expparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.underlying_model.simulate_experiment(
            generator, modelparams, expparams, repeat=repeat)

    @property
    def fused_update_supported(self):
        return False
