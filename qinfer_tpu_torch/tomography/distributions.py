"""Random-state priors. Counterpart of
``qinfer_tpu/tomography/distributions.py``: ``DensityOperatorDistribution``,
``GinibreDistribution``, ``GinibreReditDistribution``,
``BCSZChoiDistribution``, ``GADFLIDistribution`` and the legacy
``HilbertSchmidtUniform``, ``HaarUniform``, ``GinibreUniform``.

Each prior samples unit-trace states as (re, im) f32 pairs on the
generator's device and returns their coordinates (n, d²) in its basis.
The normals come from the ``torch.Generator``; the matrix arithmetic on
the pairs is in the module functions ``_cmm`` and ``_gram``, which take
the normals as arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distributions import Distribution
from ..utils import eigh_batched
from .bases import gell_mann_basis

__all__ = [
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
    "HilbertSchmidtUniform",
    "HaarUniform",
    "GinibreUniform",
]


def _cmm(ar, ai, br, bi):
    """Batched complex matmul on (re, im) pairs: (a·b)re, (a·b)im."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _gram(gr, gi):
    """G G† as a (re, im) pair, for G given as a pair (…, d, r)."""
    grt, git = gr.transpose(-1, -2), gi.transpose(-1, -2)
    return gr @ grt + gi @ git, gi @ grt - gr @ git


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None]


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


class DensityOperatorDistribution(Distribution):
    """ABC: samples density matrices and returns their coordinates in
    ``basis`` (an int d means the Gell-Mann basis of dimension d).
    Subclasses implement ``_sample_pairs(generator, n) -> (re, im)`` of
    unit-trace states."""

    def __init__(self, basis):
        if isinstance(basis, int):
            basis = gell_mann_basis(basis)
        self.basis = basis

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_rvs(self):
        return self.basis.n_elements

    def _sample_pairs(self, generator, n):
        raise NotImplementedError

    def sample(self, generator, n: int = 1):
        re, im = self._sample_pairs(generator, n)
        return self.basis.coords_from_real_imag(re, im)

    def _sample_states(self, generator, n):
        """Complex density matrices as a NumPy array (host)."""
        re, im = self._sample_pairs(generator, n)
        return re.cpu().numpy() + 1j * im.cpu().numpy()


class GinibreDistribution(DensityOperatorDistribution):
    """Ginibre-induced states ρ = GG†/Tr(GG†), G a d×rank complex normal
    matrix; rank None is full rank (Hilbert–Schmidt measure), rank 1 gives
    Haar-random pure states."""

    def __init__(self, basis, rank: Optional[int] = None):
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, generator, n):
        d = self.dim
        rank = self.rank if self.rank is not None else d
        gr = _normal(generator, (n, d, rank))
        gi = _normal(generator, (n, d, rank))
        re, im = _gram(gr, gi)
        tr = _trace(re)
        return re / tr, im / tr


class GinibreReditDistribution(DensityOperatorDistribution):
    """Real-Ginibre states (rebits): G real, so ρ is real symmetric."""

    def __init__(self, basis, rank: Optional[int] = None):
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, generator, n):
        d = self.dim
        rank = self.rank if self.rank is not None else d
        G = _normal(generator, (n, d, rank))
        re = G @ G.transpose(-1, -2)
        return re / _trace(re), torch.zeros_like(re)


class BCSZChoiDistribution(DensityOperatorDistribution):
    """BCSZ-random CPTP channels as normalized Choi states.

    W = GG† with G a (d_in·d_out)×rank complex normal matrix;
    Λ = (Q^{-1/2} ⊗ 1) W (Q^{-1/2} ⊗ 1) with Q = Tr_out W, which makes the
    channel trace preserving; the state is Λ over its trace. Q^{-1/2}
    comes from a batched ``eigh`` of the real embedding of Q
    (``utils.eigh_batched``).
    """

    def __init__(self, basis_or_dim, rank: Optional[int] = None):
        if isinstance(basis_or_dim, int):
            basis = gell_mann_basis(basis_or_dim ** 2)
            self._d_in = basis_or_dim
            self._d_out = basis_or_dim
        else:
            basis = basis_or_dim
            d2 = basis.dim
            self._d_in = int(round(d2 ** 0.5))
            self._d_out = d2 // self._d_in
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, generator, n):
        d_in, d_out = self._d_in, self._d_out
        D = d_in * d_out
        rank = self.rank if self.rank is not None else D
        gr = _normal(generator, (n, D, rank))
        gi = _normal(generator, (n, D, rank))
        w_re, w_im = _gram(gr, gi)  # (n, D, D) Hermitian pair

        # Partial trace over the output: index a = (i_in, i_out).
        q_re = torch.einsum("niaja->nij", w_re.reshape(n, d_in, d_out, d_in,
                                                        d_out))
        q_im = torch.einsum("niaja->nij", w_im.reshape(n, d_in, d_out, d_in,
                                                        d_out))

        top = torch.cat([q_re, -q_im], dim=-1)
        bot = torch.cat([q_im, q_re], dim=-1)
        evals, evecs = eigh_batched(torch.cat([top, bot], dim=-2))
        inv_sqrt = 1.0 / torch.sqrt(torch.clamp(evals, min=1e-12))
        s_emb = (evecs * inv_sqrt[:, None, :]) @ evecs.transpose(-1, -2)
        s_re = 0.5 * (s_emb[:, :d_in, :d_in] + s_emb[:, d_in:, d_in:])
        s_im = 0.5 * (s_emb[:, d_in:, :d_in] - s_emb[:, :d_in, d_in:])

        # Q^{-1/2} ⊗ I on the D-dimensional space.
        eye = torch.eye(d_out, dtype=s_re.dtype, device=s_re.device)
        S_re = torch.einsum("nij,ab->niajb", s_re, eye).reshape(n, D, D)
        S_im = torch.einsum("nij,ab->niajb", s_im, eye).reshape(n, D, D)

        sw_re, sw_im = _cmm(S_re, S_im, w_re, w_im)
        c_re, c_im = _cmm(sw_re, sw_im, S_re, S_im)
        tr = _trace(c_re)
        return c_re / tr, c_im / tr


class GADFLIDistribution(DensityOperatorDistribution):
    """Fiducial-anchored prior: ρ = α·ρ_fiducial + (1−α)·σ with σ drawn from
    ``underlying`` and α ~ U[0, max_alpha]."""

    def __init__(self, underlying: DensityOperatorDistribution,
                 fiducial_state, max_alpha: float = 1.0):
        super().__init__(underlying.basis)
        self.underlying = underlying
        fid = np.asarray(fiducial_state, dtype=np.complex64)
        self.fiducial_state = fid
        self._fid_re = torch.from_numpy(fid.real.copy())
        self._fid_im = torch.from_numpy(fid.imag.copy())
        self.max_alpha = float(max_alpha)

    def _sample_pairs(self, generator, n):
        device = generator.device
        alpha = self.max_alpha * torch.rand((n, 1, 1), generator=generator,
                                            device=device)
        s_re, s_im = self.underlying._sample_pairs(generator, n)
        fid_re, fid_im = self._fid_re.to(device), self._fid_im.to(device)
        return (alpha * fid_re[None] + (1.0 - alpha) * s_re,
                alpha * fid_im[None] + (1.0 - alpha) * s_im)


class HilbertSchmidtUniform(GinibreDistribution):
    """Legacy alias: full-rank Ginibre (Hilbert–Schmidt-uniform states)."""

    def __init__(self, dim=2):
        super().__init__(gell_mann_basis(dim), rank=None)


class HaarUniform(GinibreDistribution):
    """Legacy alias: rank-1 Ginibre (Haar-random pure states)."""

    def __init__(self, dim=2):
        super().__init__(gell_mann_basis(dim), rank=1)


class GinibreUniform(GinibreDistribution):
    """Legacy alias: Ginibre mixed states of a given rank (None: full)."""

    def __init__(self, rank=None, dim=2):
        super().__init__(gell_mann_basis(dim), rank=rank)
