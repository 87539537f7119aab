"""Models. Counterpart of ``qinfer_tpu/models`` (the main path's part)."""

from .base import FiniteOutcomeModel, Model, Simulatable, expparams_field
from .test_models import SimplePrecessionModel

__all__ = [
    "Simulatable", "Model", "FiniteOutcomeModel", "expparams_field",
    "SimplePrecessionModel",
]
