"""qinfer_tpu_torch — the SMC inference engine of ``qinfer_tpu`` in PyTorch.

A port of the JAX package to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (H100). Module names mirror ``qinfer_tpu`` so each
counterpart is easy to find. This package holds the main path:
``SimplePrecessionModel`` with a ``UniformDistribution`` prior, the fused
Bayes update (kernel B1), the ESS check and the Liu–West resample with the
systematic expand (kernel B2), driven by ``SMCUpdater.batch_update``; and
the model zoo of BASELINE configs 2–4 (``BinomialModel``,
``RandomizedBenchmarkingModel``, ``MultiCosModel``,
``KnownT2PrecessionModel`` and the other two-outcome test models), each
with its likelihood tile in B1; and ``tomography`` (bases, priors,
``TomographyModel`` with B1's Born tile) with the experiment-design half
of the engine (``SMCUpdater.bayes_risk`` and
``SMCUpdater.expected_information_gain``), which drive BASELINE config 5's
adaptive loop; and the adaptive and ensemble layer: the heuristics (``PGH``,
``ExpSparseHeuristic``, the EIG and risk greedy cores), the simulator
(``simulate_experiment``), ``ExperimentDesigner``, ``simple_est_prec`` and
``simple_est_rb``, and ``perf_test`` / ``perf_test_multiple``, which run
trial ensembles in lockstep through the batched forms of B1 and B2; and
the rest of the engine API: the resampling-divergence record, credible
regions, posterior marginals and meshes, the plots and ``sample`` of
``SMCUpdater``, ``SMCUpdaterBCRB`` over ``DifferentiableModel``'s
autograd score (with ``ScoreMixin`` and ``FiniteDifference``), and
``MixedApproximateSMCUpdater`` with the approximate models
``ALEApproximateModel`` and ``PoisonedModel``
(``AcceleratedPrecessionModel`` is the reference-named precession model);
and the rest of the model zoo: vector outcomes (``MultinomialModel`` over
``NDieModel``, on ``MultinomialDomain``), the time-dependent
``RandomWalkModel`` and ``GaussianRandomWalkModel``, ``MLEModel`` and
``ReferencedPoissonModel``, which the SMC step updates unfused, with the
domains and every distribution of the JAX package; and the distributed
layer (``parallel``: the sharded SMC step over the ranks of a
``torch.distributed`` process group, distributed systematic resampling,
sharded design and adaptive episodes, ``DirectViewParallelizedModel``);
and the auxiliary modules: ``checkpointing``, ``profiling``
(``ThroughputMeter``, ``trace``, and the program's spans and counters:
``span``, ``annotate``, ``recorded``, ``counters``), ``clustering`` and
``metrics`` with ``ClusteringResampler`` and the cluster estimators (on
the host, with scikit-learn), ``ipy`` and ``version``.
Entry points run on the card unless the caller passes ``device="cpu"``.
It imports ``torch`` and never ``jax``.
"""

from .version import __version__
from ._exceptions import ApproximationWarning, ResamplerError, ResamplerWarning
from .domains import Domain, IntegerDomain, MultinomialDomain, RealDomain
from .distributions import (
    BetaBinomialDistribution,
    BetaDistribution,
    ConstantDistribution,
    ConstrainedSumDistribution,
    DiscreteUniformDistribution,
    Distribution,
    GammaDistribution,
    InterpolatedUnivariateDistribution,
    LogNormalDistribution,
    MixtureDistribution,
    MultivariateNormalDistribution,
    MVUniformDistribution,
    NormalDistribution,
    ParticleDistribution,
    PostselectedDistribution,
    ProductDistribution,
    SingleSampleMixin,
    SlantedNormalDistribution,
    UniformDistribution,
)
from .expdesign import ExperimentDesigner, OptimizationAlgorithms
from .heuristics import (
    EIGHeuristic,
    ExpSparseHeuristic,
    Heuristic,
    PGH,
    RiskHeuristic,
)
from .finite_difference import FiniteDifference
from .models import (
    ALEApproximateModel,
    AcceleratedPrecessionModel,
    BinomialModel,
    CoinModel,
    DerivedModel,
    DifferentiableBinomialModel,
    DifferentiableModel,
    FiniteOutcomeModel,
    GaussianRandomWalkModel,
    KnownT2PrecessionModel,
    MLEModel,
    Model,
    MultiCosModel,
    MultinomialModel,
    NDieModel,
    NoisyCoinModel,
    PoisonedModel,
    RandomizedBenchmarkingModel,
    RandomWalkModel,
    ReferencedPoissonModel,
    SimpleInversionModel,
    SimplePrecessionModel,
    Simulatable,
    binom_est_error,
    binom_est_p,
    rb,
)
from .perf_testing import perf_test, perf_test_multiple, run_episodes, timing
from .resamplers import ClusteringResampler, LiuWestResampler, Resampler
from .score import ScoreMixin
from .simple_est import load_data_or_txt, simple_est_prec, simple_est_rb
from .smc import (
    MixedApproximateSMCUpdater,
    SMCConfig,
    SMCState,
    SMCUpdater,
    SMCUpdaterBCRB,
    init_batched_smc_state,
    init_smc_state,
    bayes_risk_fn,
    expected_information_gain_fn,
    hypothetical_log_update,
    smc_batch_update,
    smc_update_step,
    smc_update_step_batched,
)
from .clustering import NOISE, particle_clusters
from .ipy import IPythonProgressBar
from .metrics import rescaled_distance_mtx, weighted_pairwise_distances
from .profiling import (
    ThroughputMeter,
    annotate,
    counters,
    recorded,
    span,
    trace,
)
from .parallel import DirectViewParallelizedModel
from . import checkpointing, parallel, tomography, utils

__all__ = [
    "__version__",
    "ApproximationWarning", "ResamplerWarning", "ResamplerError",
    "Domain", "RealDomain", "IntegerDomain", "MultinomialDomain",
    "Distribution", "SingleSampleMixin", "UniformDistribution",
    "MVUniformDistribution", "DiscreteUniformDistribution",
    "ConstantDistribution", "NormalDistribution",
    "MultivariateNormalDistribution", "SlantedNormalDistribution",
    "LogNormalDistribution", "BetaDistribution", "BetaBinomialDistribution",
    "GammaDistribution", "ProductDistribution", "MixtureDistribution",
    "PostselectedDistribution", "ConstrainedSumDistribution",
    "InterpolatedUnivariateDistribution", "ParticleDistribution",
    "Heuristic", "ExpSparseHeuristic", "PGH", "EIGHeuristic",
    "RiskHeuristic", "ExperimentDesigner", "OptimizationAlgorithms",
    "perf_test", "perf_test_multiple", "run_episodes", "timing",
    "simple_est_prec", "simple_est_rb", "load_data_or_txt",
    "Simulatable", "Model", "FiniteOutcomeModel", "DifferentiableModel",
    "SimplePrecessionModel", "AcceleratedPrecessionModel",
    "SimpleInversionModel", "CoinModel", "NoisyCoinModel", "NDieModel",
    "MultiCosModel", "KnownT2PrecessionModel", "DerivedModel",
    "BinomialModel", "DifferentiableBinomialModel", "MultinomialModel",
    "PoisonedModel", "RandomWalkModel", "GaussianRandomWalkModel",
    "MLEModel", "ReferencedPoissonModel",
    "RandomizedBenchmarkingModel", "rb",
    "ALEApproximateModel", "binom_est_p", "binom_est_error",
    "FiniteDifference", "ScoreMixin",
    "Resampler", "LiuWestResampler", "ClusteringResampler",
    "SMCConfig", "SMCState", "SMCUpdater", "SMCUpdaterBCRB",
    "MixedApproximateSMCUpdater", "init_smc_state",
    "smc_update_step", "smc_batch_update", "hypothetical_log_update",
    "init_batched_smc_state", "smc_update_step_batched",
    "bayes_risk_fn", "expected_information_gain_fn",
    "particle_clusters", "NOISE",
    "rescaled_distance_mtx", "weighted_pairwise_distances",
    "IPythonProgressBar", "checkpointing", "ThroughputMeter", "trace",
    "annotate", "span", "recorded", "counters",
    "DirectViewParallelizedModel", "parallel",
    "tomography", "utils",
]
