"""Faults planted in the Liu–West resample for the two-qubit cell, beside
``faults.py``'s: each a list of (object, attribute, replacement) patches of
``qinfer_tpu_torch``.

- ``smear_without_root``: the smear's noise is not shaped by Σ^{1/2}: the
  noise is h·ε, as if the covariance were the identity;
- ``postselect_unchecked``: postselection takes every drawn row as valid,
  without the validity test.
"""

from __future__ import annotations

import torch


def _smear_without_root():
    from qinfer_tpu_torch import resamplers

    def root(self, cov):
        d = cov.shape[-1]
        return self._h * torch.eye(d, dtype=cov.dtype,
                                   device=cov.device).expand_as(cov)

    return [(resamplers.LiuWestResampler, "_root", root)]


def _postselect_unchecked():
    from qinfer_tpu_torch import resamplers

    def valid(model, locs):
        return torch.ones(locs.shape[0], dtype=torch.bool,
                          device=locs.device)

    return [(resamplers.LiuWestResampler, "_valid", staticmethod(valid))]


FAULTS = {"smear_without_root": _smear_without_root,
          "postselect_unchecked": _postselect_unchecked}


def patches(name):
    return FAULTS[name]()
