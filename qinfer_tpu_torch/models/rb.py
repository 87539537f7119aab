"""Randomized benchmarking. Counterpart of ``qinfer_tpu/models/rb.py``:
``RandomizedBenchmarkingModel`` (standard and interleaved) and the
fidelity conversions ``p`` and ``F``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import FiniteOutcomeModel, _column

__all__ = ["RandomizedBenchmarkingModel", "p", "F"]


def p(F, d=2):
    """Depolarizing parameter from average gate fidelity:
    p = (d·F − 1)/(d − 1)."""
    return (d * F - 1.0) / (d - 1.0)


def F(p, d=2):
    """Average gate fidelity from the depolarizing parameter:
    F = p + (1 − p)/d."""
    return p + (1.0 - p) / d


@dataclass(frozen=True, eq=False)
class RandomizedBenchmarkingModel(FiniteOutcomeModel):
    """Zeroth-order RB decay model; outcome 0 is survival.

    Standard mode, modelparams (p, A, B): Pr(0 | m) = A·pᵐ + B.
    Interleaved mode, modelparams (p̃, p_ref, A, B), expparams field
    'reference': Pr(0 | m, reference=1) = A·p_refᵐ + B and
    Pr(0 | m, reference=0) = A·(p̃·p_ref)ᵐ + B.
    Valid: decays in [0, 1], A, B ≥ 0, A + B ≤ 1.

    ``pr0`` clips the decay at 1e-38, the fused tile at 1e-20, as the
    JAX package does (a kept divergence between its two paths).
    """

    interleaved: bool = False

    @property
    def n_modelparams(self):
        return 4 if self.interleaved else 3

    @property
    def modelparam_names(self):
        if self.interleaved:
            return ("p_tilde", "p_ref", "A", "B")
        return ("p", "A", "B")

    @property
    def expparams_dtype(self):
        base = [("m", "uint")]
        if self.interleaved:
            base.append(("reference", "int"))
        return base

    def are_models_valid(self, modelparams):
        if self.interleaved:
            pt, pr_, A, B = (modelparams[:, i] for i in range(4))
            p_ok = (pt >= 0) & (pt <= 1) & (pr_ >= 0) & (pr_ <= 1)
        else:
            p_, A, B = (modelparams[:, i] for i in range(3))
            p_ok = (p_ >= 0) & (p_ <= 1)
        return p_ok & (A >= 0) & (B >= 0) & (A + B <= 1)

    def canonicalize(self, modelparams):
        """Clip to [0, 1], then scale A and B down to A + B = 1 where the
        sum exceeds 1."""
        mp = torch.clamp(modelparams, 0.0, 1.0)
        A, B = mp[:, -2], mp[:, -1]
        total = A + B
        scale = torch.where(total > 1.0,
                            1.0 / torch.clamp(total, min=1e-9), 1.0)
        return torch.cat([mp[:, :-2], (A * scale)[:, None],
                          (B * scale)[:, None]], dim=1)

    def pr0(self, modelparams, expparams):
        m = _column(expparams, "m", modelparams.device)
        if self.interleaved:
            ref = _column(expparams, "reference", modelparams.device)
            pt, pr_ = modelparams[:, 0], modelparams[:, 1]
            A, B = modelparams[:, 2], modelparams[:, 3]
            decay = torch.where(ref[None, :] == 1, pr_[:, None],
                                (pt * pr_)[:, None])
        else:
            decay = modelparams[:, 0][:, None]
            A, B = modelparams[:, 1], modelparams[:, 2]
        pm = torch.exp(m[None, :] * torch.log(torch.clamp(decay, 1e-38, 1.0)))
        return torch.clamp(A[:, None] * pm + B[:, None], 0.0, 1.0)

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import rb_interleaved_pr1, rb_pr1

        m = _column(expparams, "m", modelparams.device)
        cols = tuple(modelparams[..., i] for i in range(self.n_modelparams))
        if self.interleaved:
            ref = _column(expparams, "reference", modelparams.device)
            return (rb_interleaved_pr1,
                    torch.stack([m, ref], dim=1).reshape(-1), cols)
        return rb_pr1, m, cols
