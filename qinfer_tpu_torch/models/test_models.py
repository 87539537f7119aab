"""Example models. Counterpart of ``qinfer_tpu/models/test_models.py``
(``SimplePrecessionModel`` only)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import FiniteOutcomeModel, expparams_field

__all__ = ["SimplePrecessionModel"]


def _t_column(expparams, device):
    t = expparams_field(expparams, "t")
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1)


@dataclass(frozen=True, eq=False)
class SimplePrecessionModel(FiniteOutcomeModel):
    """Single-frequency precession: Pr(0 | ω; t) = cos²(ω t / 2).
    ``min_freq`` bounds validity: ω ≥ min_freq."""

    min_freq: float = 0.0

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("omega",)

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def are_models_valid(self, modelparams):
        return torch.all(modelparams >= self.min_freq, dim=-1)

    def canonicalize(self, modelparams):
        return torch.clamp(modelparams, min=self.min_freq)

    def pr0(self, modelparams, expparams):
        t = _t_column(expparams, modelparams.device)
        omega = modelparams[:, 0]
        arg = 0.5 * omega[:, None] * t[None, :]
        return torch.cos(arg) ** 2

    def _fused_pr1_parts(self, modelparams, expparams):
        """Fused single-pass update spec: ``precession_pr1`` over ω."""
        from ..ops.fused_update import precession_pr1

        t = _t_column(expparams, modelparams.device)[:1]
        return precession_pr1, t, (modelparams[:, 0],)
