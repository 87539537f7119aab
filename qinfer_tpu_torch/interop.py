"""Carry state and static objects across from the JAX package.

``state_from_numpy`` takes the JAX ``SMCState`` as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, state)``, or a dict with the
same field names) and returns this package's ``SMCState``;
``state_to_numpy`` goes back to a dict of numpy arrays. The JAX key is not
carried: the port seeds its own ``torch.Generator``. ``shard_from_numpy``
carries the same state to one rank's block of a bank spread over a mesh
(``state_from_numpy`` and then ``parallel.shard_state``), so that a test
can feed the JAX package's ``shard_map`` step and the port's sharded step
one bank.

``from_reference`` converts the ported static objects by their fields:
- the models of ``models/`` (``AcceleratedPrecessionModel`` included),
  and the combinators with their inner models converted in turn:
  ``BinomialModel`` and ``PoisonedModel`` (``tol``, ``n_samples``,
  ``hedge``, ``seed``) over their underlying model,
  ``ALEApproximateModel`` over its simulator (with ``error_tol``,
  ``min_samp``, ``samp_step``, ``est_hedge``, ``max_samp``, ``seed``);
- the rest of the model zoo: ``NDieModel``, and ``MultinomialModel``,
  ``RandomWalkModel`` (with its step distribution), ``GaussianRandomWalkModel``
  (``diagonal``), ``MLEModel`` (``likelihood_power``) and
  ``ReferencedPoissonModel`` (``max_rate``) over their underlying models;
- the domains (``RealDomain``, ``IntegerDomain``, ``MultinomialDomain``);
- every distribution by its fields, the composite ones (product,
  mixture, postselected, constrained sum) with their parts converted in
  turn; ``InterpolatedUnivariateDistribution`` keeps the same ``pdf``
  callable, which must take NumPy scalars; ``ParticleDistribution`` by
  its locations and log-weights;
- ``LiuWestResampler``, ``ClusteringResampler`` (with its secondary
  resampler converted in turn) and ``SMCConfig``
  (``SMCConfig.canonicalize``, which the JAX engine never reads, is not
  carried);
- from ``tomography/`` the bases (by ``data``, ``dims``, ``labels``),
  both models (by basis, ``allow_subnormalized``, ``psd_tol``) and every
  prior (by basis, ``rank``, the fiducial state and ``max_alpha``);
- the heuristics ``ExpSparseHeuristic`` and ``PGH`` (by their cores'
  fields, without an updater; ``inv_func`` and ``t_func`` only when they
  are the JAX package's identity, else the converter raises).

A whole ``SMCUpdaterBCRB`` is carried by ``state_from_numpy`` for its bank
and ``SMCUpdaterBCRB(…, initial_bim=np.asarray(jax_updater.current_bim))``
for its information matrix. Nothing here imports ``jax``.
"""

from __future__ import annotations

import sys
from collections.abc import Mapping

import numpy as np
import torch

from . import distributions as dists
from . import domains, heuristics, models, tomography
from .resamplers import ClusteringResampler, LiuWestResampler
from .smc import SMCConfig, SMCState

__all__ = ["state_from_numpy", "state_to_numpy", "shard_from_numpy",
           "from_reference"]

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


def shard_from_numpy(d, mesh, device="cpu", generator=None, seed=0):
    """This rank's block of the JAX state's bank on ``mesh`` (see
    ``parallel.shard_state``); ``generator``/``seed`` as in
    ``state_from_numpy``, alike on every rank."""
    from .parallel import shard_state

    return shard_state(state_from_numpy(d, device, generator, seed), mesh)


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


def _basis(obj):
    return tomography.TomographyBasis(np.asarray(obj.data), dims=obj.dims,
                                      labels=obj.labels)


def _tomography_model(cls):
    return lambda obj: cls(basis=_basis(obj.basis),
                           allow_subnormalized=obj.allow_subnormalized,
                           psd_tol=obj.psd_tol)


def _ranked_prior(cls):
    return lambda obj: cls(_basis(obj.basis), rank=obj.rank)


def _gadfli(obj):
    fiducial = np.asarray(obj._fid_re) + 1j * np.asarray(obj._fid_im)
    return tomography.GADFLIDistribution(
        from_reference(obj.underlying), fiducial, max_alpha=obj.max_alpha)


def _exp_sparse(obj):
    core = obj.core
    return heuristics.ExpSparseHeuristic(
        None, scale=core.scale, base=core.base, t_field=core.t_field,
        other_fields=core.other_fields)


def _pgh(obj):
    core = obj.core
    # The JAX package's identity: its module's ``_identity``, looked up
    # among the loaded modules (nothing is imported).
    identity = getattr(sys.modules.get(type(obj).__module__), "_identity",
                       None)
    for name in ("inv_func", "t_func"):
        if getattr(core, name) is not identity:
            raise ValueError(
                f"a PGH with a custom JAX {name} cannot be carried across; "
                "pass a torch function to the port's PGH")
    return heuristics.PGH(None, inv_field=core.inv_field,
                          t_field=core.t_field, maxiters=core.maxiters,
                          other_fields=core.other_fields)


_CONVERTERS = {
    "SimplePrecessionModel":
        lambda obj: models.SimplePrecessionModel(min_freq=obj.min_freq),
    "AcceleratedPrecessionModel":
        lambda obj: models.AcceleratedPrecessionModel(min_freq=obj.min_freq),
    "SimpleInversionModel":
        lambda obj: models.SimpleInversionModel(min_freq=obj.min_freq),
    "CoinModel": lambda obj: models.CoinModel(),
    "NoisyCoinModel": lambda obj: models.NoisyCoinModel(),
    "MultiCosModel": lambda obj: models.MultiCosModel(n_terms=obj.n_terms),
    "KnownT2PrecessionModel": lambda obj: models.KnownT2PrecessionModel(
        t2=obj.t2, min_freq=obj.min_freq),
    "RandomizedBenchmarkingModel": lambda obj:
        models.RandomizedBenchmarkingModel(interleaved=obj.interleaved),
    "BinomialModel": lambda obj: models.BinomialModel(
        from_reference(obj.underlying_model)),
    "DifferentiableBinomialModel": lambda obj:
        models.DifferentiableBinomialModel(
            from_reference(obj.underlying_model)),
    "PoisonedModel": lambda obj: models.PoisonedModel(
        from_reference(obj.underlying_model), tol=obj.tol,
        n_samples=obj.n_samples, hedge=obj.hedge, seed=obj.seed),
    "ALEApproximateModel": lambda obj: models.ALEApproximateModel(
        from_reference(obj.simulator), error_tol=obj.error_tol,
        min_samp=obj.min_samp, samp_step=obj.samp_step,
        est_hedge=obj.est_hedge, max_samp=obj.max_samp, seed=obj.seed),
    "NDieModel": lambda obj: models.NDieModel(n=obj.n),
    "MultinomialModel": lambda obj: models.MultinomialModel(
        from_reference(obj.underlying_model)),
    "RandomWalkModel": lambda obj: models.RandomWalkModel(
        from_reference(obj.underlying_model),
        from_reference(obj.step_distribution)),
    "GaussianRandomWalkModel": lambda obj: models.GaussianRandomWalkModel(
        from_reference(obj.underlying_model), diagonal=obj.diagonal),
    "MLEModel": lambda obj: models.MLEModel(
        from_reference(obj.underlying_model),
        likelihood_power=obj.likelihood_power),
    "ReferencedPoissonModel": lambda obj: models.ReferencedPoissonModel(
        from_reference(obj.underlying_model), max_rate=obj.max_rate),
    "RealDomain": lambda obj: domains.RealDomain(min=obj.min, max=obj.max),
    "IntegerDomain": lambda obj: domains.IntegerDomain(min=obj.min,
                                                       max=obj.max),
    "MultinomialDomain": lambda obj: domains.MultinomialDomain(
        n_meas=obj.n_meas, n_elements=obj.n_elements),
    "UniformDistribution": lambda obj: dists.UniformDistribution(obj.ranges),
    "MVUniformDistribution": lambda obj: dists.MVUniformDistribution(
        dim=obj.dim),
    "DiscreteUniformDistribution": lambda obj:
        dists.DiscreteUniformDistribution(num_bits=obj.num_bits),
    "ConstantDistribution": lambda obj: dists.ConstantDistribution(
        obj.values),
    "NormalDistribution": lambda obj: dists.NormalDistribution(
        mean=obj.mean, var=obj.var, trunc=obj.trunc),
    "MultivariateNormalDistribution": lambda obj:
        dists.MultivariateNormalDistribution(obj.mean, obj.cov),
    "SlantedNormalDistribution": lambda obj: dists.SlantedNormalDistribution(
        obj.ranges, weight=obj.weight),
    "LogNormalDistribution": lambda obj: dists.LogNormalDistribution(
        mu=obj.mu, sigma=obj.sigma),
    "BetaDistribution": lambda obj: dists.BetaDistribution(obj.alpha,
                                                           obj.beta),
    "BetaBinomialDistribution": lambda obj: dists.BetaBinomialDistribution(
        obj.n, obj.alpha, obj.beta),
    "GammaDistribution": lambda obj: dists.GammaDistribution(obj.alpha,
                                                             obj.beta),
    "ProductDistribution": lambda obj: dists.ProductDistribution(
        [from_reference(f) for f in obj.factors]),
    "MixtureDistribution": lambda obj: dists.MixtureDistribution(
        obj.weights, [from_reference(d) for d in obj.dist]),
    "PostselectedDistribution": lambda obj: dists.PostselectedDistribution(
        from_reference(obj.dist), from_reference(obj.model),
        maxiters=obj.maxiters),
    "ConstrainedSumDistribution": lambda obj:
        dists.ConstrainedSumDistribution(
            from_reference(obj.underlying_distribution),
            desired_total=obj.desired_total),
    "InterpolatedUnivariateDistribution": lambda obj:
        dists.InterpolatedUnivariateDistribution(
            obj.pdf, compactification_scale=obj.compactification_scale,
            n_interp_points=obj.n_interp_points),
    "ParticleDistribution": lambda obj: dists.ParticleDistribution(
        np.array(obj.particle_locations),
        log_weights=np.array(obj.particle_log_weights)),
    "TomographyBasis": _basis,
    "TomographyModel": _tomography_model(tomography.TomographyModel),
    "DiffusiveTomographyModel":
        _tomography_model(tomography.DiffusiveTomographyModel),
    "GinibreDistribution": _ranked_prior(tomography.GinibreDistribution),
    "GinibreReditDistribution":
        _ranked_prior(tomography.GinibreReditDistribution),
    "BCSZChoiDistribution": _ranked_prior(tomography.BCSZChoiDistribution),
    "GADFLIDistribution": _gadfli,
    "HilbertSchmidtUniform":
        lambda obj: tomography.HilbertSchmidtUniform(dim=obj.basis.dim),
    "HaarUniform": lambda obj: tomography.HaarUniform(dim=obj.basis.dim),
    "GinibreUniform": lambda obj: tomography.GinibreUniform(
        rank=obj.rank, dim=obj.basis.dim),
    "LiuWestResampler": _resampler,
    "ClusteringResampler": lambda obj: ClusteringResampler(
        eps=obj.eps, min_particles=obj.min_particles,
        secondary_resampler=from_reference(obj.secondary_resampler),
        weighted=obj.weighted, quiet=obj.quiet),
    "ExpSparseHeuristic": _exp_sparse,
    "PGH": _pgh,
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
