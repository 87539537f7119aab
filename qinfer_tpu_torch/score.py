"""Score mixin. Counterpart of ``qinfer_tpu/score.py``: ``ScoreMixin`` gives
any model ``DifferentiableModel``'s score and Fisher information, derived
by autograd (``class M(ScoreMixin, SomeModel)``)."""

from __future__ import annotations

from .models.base import DifferentiableModel

__all__ = ["ScoreMixin"]


class ScoreMixin:
    """Adds ``score`` and ``fisher_information`` to a torch model."""

    score = DifferentiableModel.score
    fisher_information = DifferentiableModel.fisher_information
