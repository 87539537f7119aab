"""Resamplers on torch tensors.

Counterpart of ``qinfer_tpu/resamplers.py``: the integer-quantized
systematic segment starts, the systematic and multinomial index draws, and
``LiuWestResampler``. Randomness comes from an explicit ``torch.Generator``;
the stratum offset ``u0`` and the smear noise (the ``kernel=`` hook) can be
injected, which is how the tests feed both packages the same draws.

Not ported, on purpose: ``systematic_pick_blocked`` and the three-level
``exact_int_cumsum`` exist for the TPU's slow gathers and scans. Here the
pick is a plain gather (or kernel B2 on CUDA) and the integer CDF is one
int64 ``torch.cumsum``, which gives the same integers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .ops.resample_expand import systematic_expand
from .utils import normalize_log_weights, sqrtm_psd, weighted_moments

__all__ = [
    "Resampler",
    "LiuWestResampler",
    "systematic_segment_starts",
    "systematic_resample_indices",
    "multinomial_resample_indices",
]

# Weight-quantization scale of the integer CDF.
_CDF_QUANT = float(1 << 30)


def systematic_segment_starts(log_w, n_draws, u0=None, generator=None):
    """Sorted int32 segment starts with starts[0] == 0.

    t_j = ceil(n·cdf_j − u0) counts the strata below cdf_j, so particle j
    covers output slots [t_{j−1}, t_j). The weights are quantized to
    integers (2⁻³⁰ granularity) and summed exactly, so the starts are
    sorted by construction. ``u0`` ~ U[0, 1) is drawn from ``generator``
    unless given (a float or a 0-d tensor).
    """
    if n_draws >= 1 << 24:
        raise ValueError(
            "systematic_segment_starts carries starts in f32 — exact only "
            f"for n_draws < 2^24 (got {n_draws})"
        )
    device = log_w.device
    w = torch.exp(normalize_log_weights(log_w)[0])
    q = torch.round(w * _CDF_QUANT).to(torch.int64)
    icdf = torch.cumsum(q, dim=0)
    total = torch.clamp(icdf[-1], min=1)
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=device)
    elif not isinstance(u0, torch.Tensor):
        u0 = torch.full((), float(u0), device=device)
    u0 = u0.to(device=device, dtype=torch.float32)
    scale = torch.full((), float(n_draws), device=device) / total.to(
        torch.float32)
    t = torch.ceil(icdf.to(torch.float32) * scale - u0)
    starts = torch.cat([torch.zeros(1, dtype=torch.float32, device=device),
                        t[:-1]])
    return torch.clamp(starts, min=0.0).to(torch.int32)


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
    """

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
        locs = particle_locations
        log_w = particle_log_weights
        n, d = locs.shape

        mu, cov = weighted_moments(log_w, locs)
        cov = cov + self.zero_cov_comp * torch.eye(d, dtype=cov.dtype,
                                                   device=cov.device)
        h = self._h
        S = sqrtm_psd((h * h) * cov)

        use_expand = (locs.is_cuda if self.use_expand_kernel is None
                      else bool(self.use_expand_kernel))
        if use_expand:
            # Kernel B2 on CUDA: the pick and the shrinkage affine in one
            # pass over the bank.
            centers = systematic_expand(
                log_w, locs, scale=self.a, shift=(1.0 - self.a) * mu,
                u0=u0, generator=generator,
            )
        else:
            if self.use_systematic:
                idx = systematic_resample_indices(log_w, u0=u0,
                                                  generator=generator)
            else:
                idx = multinomial_resample_indices(log_w, generator=generator)
            centers = self.a * locs[idx] + (1.0 - self.a) * mu[None, :]

        def draw():
            if self.kernel is not None:
                noise = self.kernel(generator, (n, d))
            else:
                noise = torch.randn((n, d), generator=generator,
                                    device=locs.device)
            return centers + noise @ S.T

        new_locs = draw()
        if not self.postselect:
            return new_locs

        # Bounded redraw, stopping as soon as every particle is valid (one
        # host sync per check: the common case costs one).
        ok = model.are_models_valid(new_locs)
        all_ok = bool(ok.all())
        for _ in range(self.maxiter):
            if all_ok:
                break
            fresh = draw()
            fresh_ok = model.are_models_valid(fresh)
            take = ~ok & fresh_ok
            new_locs = torch.where(take[:, None], fresh, new_locs)
            ok = ok | fresh_ok
            all_ok = bool(ok.all())
        if all_ok:
            return new_locs
        # Clamp stragglers to the valid region; canonicalize runs only
        # when some particle is still invalid.
        return torch.where(ok[:, None], new_locs, model.canonicalize(new_locs))
