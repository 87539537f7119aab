"""Example models. Counterpart of ``qinfer_tpu/models/test_models.py``:
the two-outcome models, each with its tile in kernel B1, and ``NDieModel``
(a ``Model`` without one, which the SMC step updates unfused)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import FiniteOutcomeModel, Model, _column, _n_exps, expparams_field

__all__ = [
    "SimplePrecessionModel", "SimpleInversionModel", "CoinModel",
    "NoisyCoinModel", "NDieModel", "MultiCosModel", "KnownT2PrecessionModel",
]


def _t_column(expparams, device):
    return _column(expparams, "t", device)


@dataclass(frozen=True, eq=False)
class _OmegaModel(FiniteOutcomeModel):
    """One frequency ω ≥ ``min_freq`` (a field of each subclass, so that
    each keeps the JAX package's field order)."""

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("omega",)

    def are_models_valid(self, modelparams):
        return torch.all(modelparams >= self.min_freq, dim=-1)

    def canonicalize(self, modelparams):
        return torch.clamp(modelparams, min=self.min_freq)


@dataclass(frozen=True, eq=False)
class SimplePrecessionModel(_OmegaModel):
    """Single-frequency precession: Pr(0 | ω; t) = cos²(ω t / 2).
    ``min_freq`` bounds validity: ω ≥ min_freq."""

    min_freq: float = 0.0

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def pr0(self, modelparams, expparams):
        t = _t_column(expparams, modelparams.device)
        omega = modelparams[:, 0]
        arg = 0.5 * omega[:, None] * t[None, :]
        return torch.cos(arg) ** 2

    def _fused_pr1_parts(self, modelparams, expparams):
        """Fused single-pass update spec: ``precession_pr1`` over ω."""
        from ..ops.fused_update import precession_pr1

        t = _t_column(expparams, modelparams.device)
        return precession_pr1, t, (modelparams[..., 0],)


@dataclass(frozen=True, eq=False)
class SimpleInversionModel(_OmegaModel):
    """Inversion (Ramsey) model: Pr(0 | ω; ω_, t) = cos²((ω − ω_) t / 2)."""

    min_freq: float = 0.0

    @property
    def expparams_dtype(self):
        return [("w_", "float"), ("t", "float")]

    def pr0(self, modelparams, expparams):
        w_ = _column(expparams, "w_", modelparams.device)
        t = _t_column(expparams, modelparams.device)
        omega = modelparams[:, 0]
        arg = 0.5 * (omega[:, None] - w_[None, :]) * t[None, :]
        return torch.cos(arg) ** 2

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import inversion_pr1

        dev = modelparams.device
        tail = torch.stack([_column(expparams, "w_", dev),
                            _t_column(expparams, dev)], dim=1).reshape(-1)
        return inversion_pr1, tail, (modelparams[..., 0],)


@dataclass(frozen=True, eq=False)
class _BiasModel(FiniteOutcomeModel):
    """One bias p ∈ [0, 1]."""

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("p",)

    def are_models_valid(self, modelparams):
        p = modelparams[:, 0]
        return (p >= 0.0) & (p <= 1.0)

    def canonicalize(self, modelparams):
        return torch.clamp(modelparams, 0.0, 1.0)


@dataclass(frozen=True, eq=False)
class CoinModel(_BiasModel):
    """Classical coin with bias p: Pr(1 | p) = p, Pr(0 | p) = 1 − p."""

    @property
    def expparams_dtype(self):
        return [("dummy", "float")]

    def pr0(self, modelparams, expparams):
        n_exp = torch.as_tensor(
            expparams_field(expparams, "dummy")).reshape(-1).shape[0]
        p = modelparams[:, 0]
        return (1.0 - p)[:, None].expand(p.shape[0], n_exp)

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import coin_pr1

        tail = torch.zeros(0, dtype=torch.float32, device=modelparams.device)
        return coin_pr1, tail, (modelparams[..., 0],)


@dataclass(frozen=True, eq=False)
class NoisyCoinModel(_BiasModel):
    """Coin read out through an asymmetric noisy channel:
    Pr(0 | p; α, β) = α·(1 − p) + β·p."""

    @property
    def expparams_dtype(self):
        return [("alpha", "float"), ("beta", "float")]

    def pr0(self, modelparams, expparams):
        alpha = _column(expparams, "alpha", modelparams.device)
        beta = _column(expparams, "beta", modelparams.device)
        p = modelparams[:, 0]
        return alpha[None, :] * (1.0 - p[:, None]) + beta[None, :] * p[:, None]

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import noisy_coin_pr1

        dev = modelparams.device
        tail = torch.stack([_column(expparams, "alpha", dev),
                            _column(expparams, "beta", dev)],
                           dim=1).reshape(-1)
        return noisy_coin_pr1, tail, (modelparams[..., 0],)


@dataclass(frozen=True, eq=False)
class NDieModel(Model):
    """An n-sided die: the model parameters are the n face probabilities,
    L[o, i, e] = p_i[o] whatever the experiment (field 'exp_num')."""

    n: int = 6

    @property
    def n_modelparams(self):
        return self.n

    @property
    def modelparam_names(self):
        return tuple(f"p_{k}" for k in range(self.n))

    @property
    def expparams_dtype(self):
        return [("exp_num", "int")]

    def n_outcomes(self, expparams=None):
        return self.n

    def are_models_valid(self, modelparams):
        nonneg = torch.all(modelparams >= 0.0, dim=-1)
        norm = torch.abs(torch.sum(modelparams, dim=-1) - 1.0) < 1e-4
        return nonneg & norm

    def canonicalize(self, modelparams):
        clipped = torch.clamp(modelparams, min=1e-7)
        return clipped / torch.sum(clipped, dim=-1, keepdim=True)

    def log_likelihood(self, outcomes, modelparams, expparams):
        n_exp = _n_exps(expparams_field(expparams, "exp_num"))
        outcomes = torch.as_tensor(outcomes, device=modelparams.device).to(
            torch.int64).reshape(-1)
        logp = torch.log(torch.clamp(modelparams[:, outcomes].T, min=1e-38))
        return logp[:, :, None].expand(logp.shape + (n_exp,))

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Faces (repeat, N, E) int32, by the inverse CDF of each row's
        face probabilities (clipped at 1e-38 and normalised) at a uniform
        draw."""
        n_exp = _n_exps(expparams_field(expparams, "exp_num"))
        p = torch.clamp(modelparams, min=1e-38)
        cdf = torch.cumsum(p, dim=1) / torch.sum(p, dim=1, keepdim=True)
        u = torch.rand((repeat, modelparams.shape[0], n_exp),
                       generator=generator, device=modelparams.device)
        return torch.sum(u[..., None] >= cdf[None, :, None, :-1],
                         dim=-1).to(torch.int32)


@dataclass(frozen=True, eq=False)
class MultiCosModel(FiniteOutcomeModel):
    """Multi-frequency precession: Pr(0 | ω⃗; t⃗) = cos²(ω⃗·t⃗ / 2).
    expparams: field 'ts' of shape (E, n_terms)."""

    n_terms: int = 2

    @property
    def n_modelparams(self):
        return self.n_terms

    @property
    def modelparam_names(self):
        return tuple(f"omega_{k}" for k in range(self.n_terms))

    @property
    def expparams_dtype(self):
        return [("ts", "float", self.n_terms)]

    def are_models_valid(self, modelparams):
        return torch.all(modelparams >= 0.0, dim=-1)

    def canonicalize(self, modelparams):
        return torch.clamp(modelparams, min=0.0)

    def pr0(self, modelparams, expparams):
        ts = _column(expparams, "ts", modelparams.device).reshape(
            -1, self.n_terms)  # (E, K)
        arg = 0.5 * (modelparams @ ts.T)  # (N, E)
        return torch.cos(arg) ** 2

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import make_multicos_pr1

        ts = _column(expparams, "ts", modelparams.device)
        cols = tuple(modelparams[..., i] for i in range(self.n_terms))
        return make_multicos_pr1(self.n_terms), ts, cols


@dataclass(frozen=True, eq=False)
class KnownT2PrecessionModel(_OmegaModel):
    """Precession with known decoherence time T2:
    Pr(0 | ω; t) = e^{−t/T2} cos²(ω t / 2) + (1 − e^{−t/T2}) / 2."""

    t2: float = 100.0
    min_freq: float = 0.0

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def pr0(self, modelparams, expparams):
        t = _t_column(expparams, modelparams.device)
        omega = modelparams[:, 0]
        decay = torch.exp(-t / self.t2)[None, :]
        coherent = torch.cos(0.5 * omega[:, None] * t[None, :]) ** 2
        return decay * coherent + 0.5 * (1.0 - decay)

    def _fused_pr1_parts(self, modelparams, expparams):
        from ..ops.fused_update import make_known_t2_pr1

        t = _t_column(expparams, modelparams.device)
        return make_known_t2_pr1(self.t2), t, (modelparams[..., 0],)
