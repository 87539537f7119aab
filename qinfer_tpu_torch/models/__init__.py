"""Models. Counterpart of ``qinfer_tpu/models``."""

from . import rb
from .accelerated import AcceleratedPrecessionModel
from .ale import ALEApproximateModel, binom_est_error, binom_est_p
from .base import (
    DifferentiableModel,
    FiniteOutcomeModel,
    Model,
    Simulatable,
    expparams_field,
)
from .derived import (
    BinomialModel,
    DerivedModel,
    DifferentiableBinomialModel,
    GaussianRandomWalkModel,
    MLEModel,
    MultinomialModel,
    PoisonedModel,
    RandomWalkModel,
    ReferencedPoissonModel,
)
from .rb import RandomizedBenchmarkingModel
from .test_models import (
    CoinModel,
    KnownT2PrecessionModel,
    MultiCosModel,
    NDieModel,
    NoisyCoinModel,
    SimpleInversionModel,
    SimplePrecessionModel,
)

__all__ = [
    "Simulatable", "Model", "FiniteOutcomeModel", "DifferentiableModel",
    "expparams_field",
    "SimplePrecessionModel", "SimpleInversionModel", "CoinModel",
    "NoisyCoinModel", "NDieModel", "MultiCosModel", "KnownT2PrecessionModel",
    "DerivedModel", "BinomialModel", "DifferentiableBinomialModel",
    "MultinomialModel", "PoisonedModel", "RandomWalkModel",
    "GaussianRandomWalkModel", "MLEModel", "ReferencedPoissonModel",
    "RandomizedBenchmarkingModel", "rb",
    "ALEApproximateModel", "binom_est_p", "binom_est_error",
    "AcceleratedPrecessionModel",
]
