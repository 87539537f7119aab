"""Models. Counterpart of ``qinfer_tpu/models`` (the ported part)."""

from . import rb
from .base import FiniteOutcomeModel, Model, Simulatable, expparams_field
from .derived import BinomialModel, DerivedModel, DifferentiableBinomialModel
from .rb import RandomizedBenchmarkingModel
from .test_models import (
    CoinModel,
    KnownT2PrecessionModel,
    MultiCosModel,
    NoisyCoinModel,
    SimpleInversionModel,
    SimplePrecessionModel,
)

__all__ = [
    "Simulatable", "Model", "FiniteOutcomeModel", "expparams_field",
    "SimplePrecessionModel", "SimpleInversionModel", "CoinModel",
    "NoisyCoinModel", "MultiCosModel", "KnownT2PrecessionModel",
    "DerivedModel", "BinomialModel", "DifferentiableBinomialModel",
    "RandomizedBenchmarkingModel", "rb",
]
