"""Tomography models. Counterpart of ``qinfer_tpu/tomography/models.py``:
``TomographyModel`` (Born rule Pr(1 | ρ, E) = Tr(ρE) = ⟨x, e⟩ in an
orthonormal basis) and ``DiffusiveTomographyModel``.

The fused update runs B1's Born tile over the coordinate columns. The
positivity test has two paths: a closed form for qubits, as in the JAX
package, and for d > 2 an LDLᴴ factorization of ρ + psd_tol·I (no
eigendecomposition; ``ops.psd_valid``, one kernel launch on a CUDA bank at
d = 3, 4 and 8). The JAX package tests the characteristic polynomial
of the real embedding there, which in f32 accepts near-low-rank states
with eigenvalues down to about −1e-2.
``canonicalize`` projects onto the physical cone: a closed-form rescale
for qubits, a batched ``eigh`` of the real embedding for d > 2.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..models.base import FiniteOutcomeModel, _column, _n_exps
from ..ops.psd_valid import (  # noqa: F401  (_psd_via_ldl, re-exported)
    _psd_via_ldl,
    psd_redraw,
    psd_valid,
    psd_valid_plain,
    psd_valid_route,
    trace_ok,
)
from ..utils import eigh_batched
from .bases import TomographyBasis

__all__ = ["TomographyModel", "DiffusiveTomographyModel"]

_SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True, eq=False)
class TomographyModel(FiniteOutcomeModel):
    """Two-outcome state tomography. Model parameters are the coordinates
    of ρ in ``basis`` (x₀ = 1/√d is unit trace); the expparams field
    'meas' holds the coordinates of the effect E, shape (E, d²);
    Pr(1) = Tr(ρE) = x·e."""

    basis: TomographyBasis = None
    allow_subnormalized: bool = False
    psd_tol: float = 1e-5

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_modelparams(self):
        return self.basis.n_elements

    @property
    def modelparam_names(self):
        return self.basis.labels

    @property
    def expparams_dtype(self):
        return [("meas", "float", self.n_modelparams)]

    def _meas(self, expparams, device):
        return _column(expparams, "meas", device).reshape(
            -1, self.basis.n_elements)  # (E, d²)

    def pr0(self, modelparams, expparams):
        pr1 = modelparams @ self._meas(expparams, modelparams.device).T
        return torch.clamp(1.0 - pr1, 0.0, 1.0)

    def _fused_pr1_parts(self, modelparams, expparams):
        """B1's Born tile over the first ``basis.n_elements`` columns; the
        scalars tail is the effect's coordinates."""
        from ..ops.fused_update import make_born_pr1

        n_el = self.basis.n_elements
        meas = _column(expparams, "meas", modelparams.device)
        cols = tuple(modelparams[..., d] for d in range(n_el))
        return make_born_pr1(n_el), meas, cols

    def are_models_valid(self, modelparams):
        """ρ ⪰ 0 (eigenvalues ≥ −psd_tol) and Tr ρ = 1 (x₀ = 1/√d). Qubits
        have the closed-form spectrum x₀/√2 ± ‖x₁:‖/√2; d > 2 factors
        ρ + psd_tol·I by LDLᴴ, in one kernel launch on a CUDA bank at d = 3
        and 4 (``ops.psd_valid``), else in plain torch."""
        if self.dim == 2:
            tau = torch.linalg.vector_norm(modelparams[:, 1:], dim=1) / _SQRT2
            psd = modelparams[:, 0] / _SQRT2 - tau >= -self.psd_tol
            return psd & trace_ok(modelparams[:, 0], 2,
                                  self.allow_subnormalized)
        test = (psd_valid if psd_valid_route(modelparams.device.type,
                                             self.dim)
                else psd_valid_plain)
        return test(modelparams, self.basis, self.psd_tol,
                    self.allow_subnormalized)

    def redraw_round(self, device):
        """``ops.psd_redraw`` with this model's basis and thresholds where
        ``are_models_valid`` takes the kernel (``psd_valid_route``: a CUDA
        bank at d = 3, 4 or 8), else None; None too for a subclass whose test
        is another (the diffusive model's ε column)."""
        if (type(self).are_models_valid is not TomographyModel.are_models_valid
                or not psd_valid_route(device.type, self.dim)):
            return None
        return functools.partial(
            psd_redraw, basis=self.basis, psd_tol=self.psd_tol,
            allow_subnormalized=self.allow_subnormalized)

    def canonicalize(self, modelparams):
        """Project onto the PSD, unit-trace cone: clip the eigenvalues at
        ``psd_tol`` and renormalize (a spectral function of the real
        embedding, which commutes with the embedding)."""
        if self.dim == 2:
            return self._canonicalize_qubit(modelparams)
        M = self.basis.real_embedding(modelparams)
        evals, evecs = eigh_batched(M)
        # Floor at psd_tol, not 0: the f32 round trip moves eigenvalues by
        # ~1e-6, which would push zero eigenvalues below −psd_tol again.
        evals = torch.clamp(evals, min=self.psd_tol)
        # The embedding's trace is 2·Tr(ρ): the eigenvalues sum to 2.
        evals = 2.0 * evals / torch.clamp(evals.sum(-1, keepdim=True),
                                          min=1e-12)
        M_fixed = (evecs * evals[..., None, :]) @ evecs.transpose(-1, -2)
        return self.basis.coords_from_embedding(M_fixed)

    def _canonicalize_qubit(self, modelparams):
        """Closed-form qubit projection, equal to the eigh path: ρ has the
        eigenvalues x₀/√2 ± τ with τ = ‖x₁:‖/√2 (the input's own half-trace,
        so states with trace drift project as the eigh path projects them),
        so clipping and renormalizing rescales the non-identity
        coordinates."""
        y = modelparams[:, 1:]
        tau = torch.linalg.vector_norm(y, dim=1) / _SQRT2
        half_tr = modelparams[:, 0] / _SQRT2
        lam_p = torch.clamp(half_tr + tau, min=self.psd_tol)
        lam_m = torch.clamp(half_tr - tau, min=self.psd_tol)
        tau_new = 0.5 * (lam_p - lam_m) / (lam_p + lam_m)
        scale = torch.where(tau > 1e-12,
                            tau_new / torch.clamp(tau, min=1e-12),
                            torch.ones_like(tau))
        x0 = torch.full_like(modelparams[:, :1], 1.0 / _SQRT2)
        return torch.cat([x0, y * scale[:, None]], dim=1)

    def trace(self, modelparams):
        return modelparams[:, 0] * math.sqrt(self.dim)

    @property
    def Q(self):
        return torch.ones(self.n_modelparams, dtype=torch.float32)


@dataclass(frozen=True, eq=False)
class DiffusiveTomographyModel(TomographyModel):
    """Tomography of a state that diffuses between experiments: a
    diffusion rate ε is the last model parameter; after each experiment the
    non-identity coordinates walk with std ε·√t and the state is projected
    back onto the physical cone. expparams: 'meas' and 't'."""

    @property
    def n_modelparams(self):
        return self.basis.n_elements + 1

    @property
    def modelparam_names(self):
        return tuple(self.basis.labels) + ("eps",)

    @property
    def expparams_dtype(self):
        return [("meas", "float", self.basis.n_elements), ("t", "float")]

    def _split(self, modelparams):
        return modelparams[:, :-1], modelparams[:, -1]

    def pr0(self, modelparams, expparams):
        coords, _ = self._split(modelparams)
        pr1 = coords @ self._meas(expparams, modelparams.device).T
        return torch.clamp(1.0 - pr1, 0.0, 1.0)

    def _fused_pr1_parts(self, modelparams, expparams):
        # The parent's Born tile reads the first basis.n_elements columns,
        # so the trailing ε column stays out of the likelihood; defined here
        # (not inherited) so that fused_update_supported accepts it.
        return TomographyModel._fused_pr1_parts(self, modelparams, expparams)

    def are_models_valid(self, modelparams):
        coords, eps = self._split(modelparams)
        return TomographyModel.are_models_valid(self, coords) & (eps >= 0)

    def canonicalize(self, modelparams):
        coords, eps = self._split(modelparams)
        fixed = TomographyModel.canonicalize(self, coords)
        return torch.cat([fixed, torch.clamp(eps, min=0.0)[:, None]], dim=1)

    def update_timestep(self, modelparams, expparams, generator=None):
        """(N, d²+1, E): each experiment's walk of the coordinates, drawn
        from ``generator`` (a fresh one seeded 0 on the bank's device when
        None), projected onto the cone; ε is kept."""
        device = modelparams.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        coords, eps = self._split(modelparams)
        n, d2 = coords.shape
        t = _column(expparams, "t", device)
        n_exp = _n_exps(expparams)
        noise = torch.randn((n, d2 - 1, n_exp), generator=generator,
                            device=device)
        scale = eps[:, None, None] * torch.sqrt(t)[None, None, :]
        walked = coords[:, 1:, None] + scale * noise
        first = coords[:, :1, None].expand(n, 1, n_exp)
        new_coords = torch.cat([first, walked], dim=1)  # (N, d², E)
        flat = new_coords.permute(0, 2, 1).reshape(n * n_exp, d2)
        fixed = TomographyModel.canonicalize(self, flat)
        fixed = fixed.reshape(n, n_exp, d2).permute(0, 2, 1)
        eps_keep = eps[:, None, None].expand(n, 1, n_exp)
        return torch.cat([fixed, eps_keep], dim=1)
