"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart of ``qinfer_tpu/ops`` (the Pallas TPU kernels):

- ``fused_update`` — kernel B1, the fused Bayes update;
- ``resample_expand`` — kernel B2, the systematic-resampling expand.
"""

from .fused_update import fused_bayes_update
from .resample_expand import expand_sorted_segments, systematic_expand

__all__ = ["fused_bayes_update", "expand_sorted_segments", "systematic_expand"]
