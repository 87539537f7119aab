"""qinfer_tpu_torch — the SMC inference engine of ``qinfer_tpu`` in PyTorch.

A port of the JAX package to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (H100). Module names mirror ``qinfer_tpu`` so each
counterpart is easy to find. This package holds the main path:
``SimplePrecessionModel`` with a ``UniformDistribution`` prior, the fused
Bayes update (kernel B1), the ESS check and the Liu–West resample with the
systematic expand (kernel B2), driven by ``SMCUpdater.batch_update``.
It imports ``torch`` and never ``jax``.
"""

from ._exceptions import ApproximationWarning
from .distributions import Distribution, ParticleDistribution, UniformDistribution
from .models import FiniteOutcomeModel, Model, SimplePrecessionModel, Simulatable
from .resamplers import LiuWestResampler, Resampler
from .smc import (
    SMCConfig,
    SMCState,
    SMCUpdater,
    init_smc_state,
    smc_batch_update,
    smc_update_step,
)
from . import utils

__all__ = [
    "ApproximationWarning",
    "Distribution", "ParticleDistribution", "UniformDistribution",
    "Simulatable", "Model", "FiniteOutcomeModel", "SimplePrecessionModel",
    "Resampler", "LiuWestResampler",
    "SMCConfig", "SMCState", "SMCUpdater", "init_smc_state",
    "smc_update_step", "smc_batch_update",
    "utils",
]
