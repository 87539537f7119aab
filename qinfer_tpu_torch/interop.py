"""Carry state and static objects across from the JAX package.

``state_from_numpy`` takes the JAX ``SMCState`` as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, state)``, or a dict with the
same field names) and returns this package's ``SMCState``;
``state_to_numpy`` goes back to a dict of numpy arrays. The JAX key is not
carried: the port seeds its own ``torch.Generator``.

``from_reference`` converts the slice's static objects
(``SimplePrecessionModel``, ``UniformDistribution``, ``LiuWestResampler``,
``SMCConfig``) by their fields; ``SMCConfig.canonicalize``, which the JAX
engine never reads, is not carried. Nothing here imports ``jax``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .distributions import UniformDistribution
from .models import SimplePrecessionModel
from .resamplers import LiuWestResampler
from .smc import SMCConfig, SMCState

__all__ = ["state_from_numpy", "state_to_numpy", "from_reference"]

_STATE_DTYPES = {
    "particle_locations": torch.float32,
    "particle_log_weights": torch.float32,
    "n_resamples": torch.int32,
    "min_n_ess": torch.float32,
    "log_total_likelihood": torch.float32,
    "just_resampled": torch.bool,
    "n_zero_weight_events": torch.int32,
}


def state_from_numpy(d, device="cpu", generator=None, seed=0) -> SMCState:
    """The port's ``SMCState`` from the JAX state's arrays, on ``device``.

    ``generator`` (else a new one seeded with ``seed`` on ``device``)
    supplies the port's randomness from here on.
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)

    def field(name):
        value = d[name] if isinstance(d, Mapping) else getattr(d, name)
        return torch.tensor(np.asarray(value), dtype=_STATE_DTYPES[name],
                            device=device)

    return SMCState(generator=generator,
                    **{name: field(name) for name in _STATE_DTYPES})


def state_to_numpy(state: SMCState) -> dict:
    """The state's arrays as numpy (the generator is not carried)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in _STATE_DTYPES}


def _resampler(obj):
    if obj.kernel is not None:
        raise ValueError(
            "a LiuWestResampler with a custom JAX noise kernel cannot be "
            "carried across; pass a torch kernel to the port's resampler"
        )
    return LiuWestResampler(
        a=obj.a, h=obj.h, maxiter=obj.maxiter, zero_cov_comp=obj.zero_cov_comp,
        postselect=obj.postselect, use_systematic=obj.use_systematic,
    )


_CONVERTERS = {
    "SimplePrecessionModel":
        lambda obj: SimplePrecessionModel(min_freq=obj.min_freq),
    "UniformDistribution": lambda obj: UniformDistribution(obj.ranges),
    "LiuWestResampler": _resampler,
    "SMCConfig": lambda obj: SMCConfig(
        resample_thresh=obj.resample_thresh,
        zero_weight_policy=obj.zero_weight_policy,
        zero_weight_thresh=obj.zero_weight_thresh,
        use_fused_update=obj.use_fused_update,
    ),
}


def from_reference(obj):
    """The port's counterpart of one of the JAX package's static objects."""
    convert = _CONVERTERS.get(type(obj).__name__)
    if convert is None:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")
    return convert(obj)
