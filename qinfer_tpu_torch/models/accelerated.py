"""Counterpart of ``qinfer_tpu/models/accelerated.py``:
``AcceleratedPrecessionModel``, the reference-named alias of
``SimplePrecessionModel``. It inherits the precession pr1 tile, so on CUDA
its update is kernel B1 with the same functor."""

from __future__ import annotations

from dataclasses import dataclass

from .test_models import SimplePrecessionModel

__all__ = ["AcceleratedPrecessionModel"]


@dataclass(frozen=True, eq=False)
class AcceleratedPrecessionModel(SimplePrecessionModel):
    """``SimplePrecessionModel`` under the reference's name."""
