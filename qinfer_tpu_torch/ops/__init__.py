"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart of ``qinfer_tpu/ops`` (the Pallas TPU kernels):

- ``fused_update`` — kernel B1, the fused Bayes update;
- ``pr1_trace`` — a model's torch pr1 traced into B1's functor;
- ``resample_expand`` — kernel B2, the systematic-resampling expand;
- ``psd_valid`` — the validity test of d = 3, 4, 8 tomography and a
  postselection redraw round on such a bank (no TPU kernel: the JAX
  package leaves its test to XLA).
"""

from .fused_update import fused_bayes_update
from .resample_expand import expand_sorted_segments, systematic_expand

__all__ = ["fused_bayes_update", "expand_sorted_segments", "systematic_expand"]
