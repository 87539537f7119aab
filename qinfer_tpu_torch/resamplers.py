"""Resamplers on torch tensors.

Counterpart of ``qinfer_tpu/resamplers.py``: the integer-quantized
systematic segment starts (kernel B2's input, computed in
``ops.resample_expand`` and exported here), the systematic and multinomial
index draws, ``LiuWestResampler`` and the host-side
``ClusteringResampler``. Randomness comes from an explicit
``torch.Generator``; the stratum offset ``u0`` and the smear noise (the
``kernel=`` hook) can be injected, which is how the tests feed both
packages the same draws.

Not ported, on purpose: ``systematic_pick_blocked`` and the three-level
``exact_int_cumsum`` exist for the TPU's slow gathers and scans. Here the
pick is a plain gather (or kernel B2 on CUDA) and the integer CDF is one
int64 ``torch.cumsum``, which gives the same integers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch

from .ops.resample_expand import (
    _affine_batched,
    _as_u0,
    expand_plain_batched,
    expand_sorted_segments_batched,
    fused_liu_west_route,
    liu_west_expand_batched,
    systematic_expand,
    systematic_segment_starts,
    systematic_segment_starts_batched,
)
from .profiling import count, span
from .utils import (
    normalize_log_weights,
    sqrtm_psd,
    weighted_moments,
    weighted_moments_batched,
)

__all__ = [
    "Resampler",
    "LiuWestResampler",
    "ClusteringResampler",
    "systematic_segment_starts",
    "systematic_segment_starts_batched",
    "systematic_resample_indices",
    "multinomial_resample_indices",
]


def systematic_resample_indices(log_w, n_draws=None, u0=None, generator=None):
    """Systematic resampling indices: for each stratum i, the particle
    max{j : starts[j] ≤ i}."""
    n = log_w.shape[0]
    n_draws = n if n_draws is None else n_draws
    starts = systematic_segment_starts(log_w, n_draws, u0=u0,
                                       generator=generator)
    rows = torch.arange(n_draws, dtype=torch.int32, device=log_w.device)
    return torch.searchsorted(starts, rows, right=True) - 1


def multinomial_resample_indices(log_w, n_draws=None, generator=None):
    """Multinomial (iid categorical) index draw — the reference's scheme."""
    n = log_w.shape[0]
    n_draws = n if n_draws is None else n_draws
    w = torch.exp(normalize_log_weights(log_w)[0])
    return torch.multinomial(w, n_draws, replacement=True,
                             generator=generator)


def _all_true(ok):
    return bool(ok.all())


def _bank_counts(bad):
    n = int(bad)
    return n, n


class Resampler:
    """ABC: ``(generator, model, locations, log_weights) -> new locations``."""

    def __call__(self, generator, model, particle_locations,
                 particle_log_weights, u0=None):
        raise NotImplementedError


@dataclass(frozen=True, eq=False)
class LiuWestResampler(Resampler):
    """Liu–West kernel-shrinkage resampler: new = a·x[idx] + (1−a)·μ +
    h·Σ^{1/2}·ε, with h = √(1−a²) unless given.

    ``maxiter`` bounds the postselection redraw rounds (each redraws every
    still-invalid particle); stragglers are then clamped by
    ``model.canonicalize``. ``kernel(generator, shape)`` replaces the
    standard-normal draw. ``use_expand_kernel``: None = kernel B2 whenever
    the bank is on CUDA; True/False force the systematic expand path
    on/off.

    ``LiuWestResampler.redraw_rounds`` counts the postselection redraw
    rounds of every resample in the process (each costs a host sync),
    ``LiuWestResampler.kernel_rounds`` those of them that took the model's
    one-launch round (``model.redraw_round``);
    ``LiuWestResampler.unfused_batched`` the batched resamples that took
    the eager chain and not ``liu_west_expand_batched``;
    ``LiuWestResampler.clamped_resamples`` the resamples whose rounds ran
    out with rows still invalid, so that the clamp ran. While a profiler
    records, the program's counters ``resamplers.LiuWestResampler.*``
    count these, the rows put through the validity test (``tested_rows``)
    and clamped (``clamped_rows``), and the resamples that clamped any
    (``clamped_resamples``), and the spans
    ``qinfer.resamplers.valid`` and ``qinfer.resamplers.clamp`` time those
    two (``profiling``).
    """

    redraw_rounds: ClassVar[int] = 0
    kernel_rounds: ClassVar[int] = 0
    unfused_batched: ClassVar[int] = 0
    clamped_resamples: ClassVar[int] = 0

    a: float = 0.98
    h: Optional[float] = None
    maxiter: int = 16
    zero_cov_comp: float = 0.0
    postselect: bool = True
    kernel: Optional[Callable] = None
    use_systematic: bool = True
    use_expand_kernel: Optional[bool] = None

    @property
    def _h(self):
        if self.h is not None:
            return float(self.h)
        return math.sqrt(1.0 - self.a ** 2)

    def __call__(self, generator, model, particle_locations,
                 particle_log_weights, u0=None):
        with span("qinfer.resamplers.resample"):
            locs = particle_locations
            log_w = particle_log_weights
            mu, _, S = self._moments(log_w, locs, weighted_moments)
            scale, shift = self._shrinkage(mu)
            if self._expand_kernel_on(locs.device):
                # Kernel B2 on CUDA: the pick and the shrinkage affine in one
                # pass over the bank.
                centers = systematic_expand(log_w, locs, scale=scale,
                                            shift=shift, u0=u0,
                                            generator=generator)
            else:
                # The pick in plain torch, under B2's span all the same.
                with span("qinfer.ops.b2"):
                    if self.use_systematic:
                        idx = systematic_resample_indices(log_w, u0=u0,
                                                          generator=generator)
                    else:
                        idx = multinomial_resample_indices(log_w,
                                                           generator=generator)
                    centers = scale * locs[idx] + shift[None, :]
            return self._postselect(model, generator, centers, S)

    def _expand_kernel_on(self, device):
        """Whether the pick takes kernel B2's wrapper (which runs its plain
        version on a CPU bank): ``use_expand_kernel``, or when it is None,
        whether the bank's ``device`` is a CUDA device."""
        if self.use_expand_kernel is None:
            return device.type == "cuda"
        return bool(self.use_expand_kernel)

    def _shrinkage(self, mu):
        """The affine of the Liu–West pick, x ↦ a·x + (1 − a)·μ, as (scale,
        shift) of one bank's μ (D,) or T banks' (T, D)."""
        return self.a, (1.0 - self.a) * mu

    def _noise(self, generator, shape, device):
        """Standard normals of ``shape`` from ``kernel`` or ``generator``."""
        if self.kernel is not None:
            return self.kernel(generator, tuple(shape))
        return torch.randn(shape, generator=generator, device=device)

    def _smear(self, generator, centers, S):
        """``centers`` + ε·Sᵀ, with ε of ``centers``' shape (``_noise``): a
        product of one bank is an ``mm``, of T banks (T, N, D) a ``bmm``."""
        noise = self._noise(generator, centers.shape, centers.device)
        return centers + noise @ S.transpose(-2, -1)

    def _moments(self, log_w, locs, moments):
        """The weighted mean, Σ + ``zero_cov_comp``·I and h·Σ^{1/2} (one bank,
        T banks or, with the sharded moments, a rank's block)."""
        with span("qinfer.resamplers.moments"):
            mu, cov = moments(log_w, locs)
            d = locs.shape[-1]
            cov = cov + self.zero_cov_comp * torch.eye(d, dtype=cov.dtype,
                                                       device=cov.device)
            return mu, cov, self._root(cov)

    def _root(self, cov):
        """h·Σ^{1/2} of one Σ or of T."""
        h = self._h
        return sqrtm_psd((h * h) * cov)

    def batched(self, generator, model, particle_locations,
                particle_log_weights, u0=None):
        """The resample of T banks at once: ``particle_locations`` (T, N,
        D), ``particle_log_weights`` (T, N), ``u0`` (T,) or None. Per trial
        the same steps as ``__call__`` (its own moments, its own
        Σ^{1/2}, its own stratum offset). Where the pick takes kernel B2,
        banks of at most 2048 rows and 8 columns on CUDA take one launch of
        ``liu_west_expand_batched``, which computes the moments, Σ^{1/2} at
        D = 1 and the starts itself (``fused_liu_west_route``); other banks
        take the eager chain, with kernel B2 for all trials in one launch
        on CUDA, its plain version on the CPU or when ``use_expand_kernel``
        is False. Either way ``u0`` is drawn first, then the smear noise
        (T, N, D), from ``kernel`` when given; postselection tests the
        flattened (T·N, D) bank.
        Returns the new (T, N, D) locations."""
        with span("qinfer.resamplers.resample"):
            locs = particle_locations
            log_w = particle_log_weights
            n_trials, n, d = locs.shape
            if not self.use_systematic:
                raise NotImplementedError(
                    "the batched resample draws systematic strata only")
            if self._expand_kernel_on(locs.device) and fused_liu_west_route(
                    locs.device.type, n, d):
                u0 = _as_u0(u0, (n_trials,), generator, locs.device)
                centers, _, cov, S = liu_west_expand_batched(
                    log_w, locs, u0, self.a, self._h, self.zero_cov_comp)
                if S is None:
                    with span("qinfer.resamplers.moments"):
                        S = self._root(cov)
            else:
                LiuWestResampler.unfused_batched += 1
                count("resamplers.LiuWestResampler.unfused_batched")
                centers, _, _, S = self._unfused_centers(log_w, locs, u0,
                                                         generator)
            return self._postselect(model, generator, centers,
                                    S).reshape(n_trials, n, d)

    def _unfused_centers(self, log_w, locs, u0, generator):
        """The eager chain of ``batched``: (the shrunk picks (T, N, D), μ
        (T, D), Σ + ``zero_cov_comp``·I (T, D, D), h·Σ^{1/2} (T, D, D)).
        With ``use_expand_kernel`` False it is all plain torch: the plain
        version of ``liu_west_expand_batched``."""
        n_trials, n, d = locs.shape
        mu, cov, S = self._moments(log_w, locs, weighted_moments_batched)
        with span("qinfer.ops.b2"):
            starts = systematic_segment_starts_batched(
                log_w, n, u0=u0, generator=generator)
            scale, shift = self._shrinkage(mu)
            if self._expand_kernel_on(locs.device):
                centers = expand_sorted_segments_batched(
                    starts, locs, scale=scale, shift=shift)
            else:
                affine = _affine_batched(scale, shift, n_trials, d,
                                         locs.device)
                centers = expand_plain_batched(starts, locs, n, affine)
        return centers, mu, cov, S

    def _postselect(self, model, generator, centers, S,
                    _all_valid=_all_true, _counts=_bank_counts):
        """The smear of ``centers`` as rows (M, D), each row redrawn while
        invalid (at most ``maxiter`` rounds) and clamped by
        ``model.canonicalize`` if still invalid: ``centers`` (N, D) with
        ``S`` = h·Σ^{1/2} (D, D), or T banks (T, N, D) with S (T, D, D).
        Every draw is one of the whole bank's noise (``_noise``). Where
        ``model.redraw_round`` gives a round for the bank's device, a
        round is that one launch on the rows still invalid (the first over
        the mask, the others over the list the last one wrote), and the
        host reads their count: ``_counts(bad)``, of this bank's count
        ``bad`` on the device, gives (this bank's, every bank's) as ints.
        Else a round is the masked chain over the whole bank, and the host
        reads ``_all_valid(ok)``: of one bank or T, ``ok.all()``. A rank's
        block of a sharded bank passes all-reduced reads, so that every
        rank redraws while any rank holds an invalid row, and a rank may
        then hold no straggler to clamp."""
        with span("qinfer.resamplers.postselect"):
            d = centers.shape[-1]
            new_locs = self._smear(generator, centers, S).reshape(-1, d)
            if not self.postselect:
                return new_locs

            # Bounded redraw, stopping as soon as every particle is valid (one
            # host sync per check: the common case costs one).
            ok = self._valid(model, new_locs)
            redraw, rows = model.redraw_round(new_locs.device), None
            with span("qinfer.sync.postselect"):
                if redraw is None:
                    all_ok = _all_valid(ok)
                else:
                    mine, bad = _counts(torch.sum(~ok))
                    all_ok = bad == 0
            for _ in range(self.maxiter):
                if all_ok:
                    break
                LiuWestResampler.redraw_rounds += 1
                count("resamplers.LiuWestResampler.redraw_rounds")
                if redraw is None:
                    fresh = self._smear(generator, centers, S).reshape(-1, d)
                    fresh_ok = self._valid(model, fresh)
                    take = ~ok & fresh_ok
                    new_locs = torch.where(take[:, None], fresh, new_locs)
                    ok = ok | fresh_ok
                    with span("qinfer.sync.postselect"):
                        all_ok = _all_valid(ok)
                    continue
                LiuWestResampler.kernel_rounds += 1
                count("resamplers.LiuWestResampler.kernel_rounds")
                count("resamplers.LiuWestResampler.tested_rows", mine)
                noise = self._noise(generator, centers.shape, centers.device)
                with span("qinfer.resamplers.valid"):
                    left, rows = redraw(new_locs, ok, centers.reshape(-1, d),
                                        S, noise.reshape(-1, d), mine, rows)
                with span("qinfer.sync.postselect"):
                    mine, bad = _counts(left)
                    all_ok = bad == 0
                rows = rows[:mine]
            if all_ok:
                return new_locs
            # Clamp the stragglers to the valid region. canonicalize is
            # row-wise, so it runs on the invalid rows only (for two-qubit
            # tomography it is a batched eigh per row).
            with span("qinfer.sync.postselect"):
                bad = torch.nonzero(~ok).squeeze(1)
            count("resamplers.LiuWestResampler.clamped_rows", bad.shape[0])
            if bad.numel() == 0:
                return new_locs
            LiuWestResampler.clamped_resamples += 1
            count("resamplers.LiuWestResampler.clamped_resamples")
            with span("qinfer.resamplers.clamp"):
                return new_locs.index_copy(0, bad,
                                           model.canonicalize(new_locs[bad]))

    @staticmethod
    def _valid(model, locs):
        """``model.are_models_valid(locs)``, counted by its rows."""
        count("resamplers.LiuWestResampler.tested_rows", locs.shape[0])
        with span("qinfer.resamplers.valid"):
            return model.are_models_valid(locs)


class ClusteringResampler(Resampler):
    """Resample within DBSCAN clusters, so that a multimodal posterior
    keeps each mode's local moments: the secondary resampler (a
    ``LiuWestResampler`` by default) runs on each cluster's particles with
    their renormalized weights, taking its draws from the one generator
    in cluster order; the noise particles are left as they are.

    Counterpart of the JAX package's ``ClusteringResampler`` ([unverified]
    against upstream qinfer, as there). The clustering runs on the host
    (scikit-learn), so ``host_side`` is True: ``SMCUpdater`` then resamples
    after the step, on the host's decision.
    """

    host_side = True

    def __init__(self, eps=0.5, min_particles=5, secondary_resampler=None,
                 weighted=False, quiet=True):
        self.eps = eps
        self.min_particles = min_particles
        self.secondary_resampler = (secondary_resampler
                                    if secondary_resampler is not None
                                    else LiuWestResampler())
        self.weighted = weighted
        self.quiet = quiet

    def __call__(self, generator, model, particle_locations,
                 particle_log_weights, u0=None):
        from .clustering import NOISE, particle_clusters

        locs = particle_locations
        w = torch.exp(normalize_log_weights(particle_log_weights)[0])
        w_host = w.cpu().numpy()
        new_locs = locs.clone()
        for label, mask in particle_clusters(
                locs, w_host, eps=self.eps, min_particles=self.min_particles,
                weighted=self.weighted, quiet=self.quiet):
            if label == NOISE:
                continue
            rows = torch.from_numpy(mask.nonzero()[0]).to(locs.device)
            sub_w = w_host[mask]
            sub_log_w = torch.log(torch.as_tensor(
                sub_w / sub_w.sum(), dtype=torch.float32, device=locs.device))
            new_locs[rows] = self.secondary_resampler(
                generator, model, locs[rows], sub_log_w)
        return new_locs
