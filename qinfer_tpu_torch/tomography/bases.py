"""Tomography operator bases. Counterpart of
``qinfer_tpu/tomography/bases.py``: ``TomographyBasis``,
``gell_mann_basis``, ``pauli_basis``, ``tensor_product_basis``.

A basis is a set of d² Hermitian matrices {B_i}, orthonormal under the
Hilbert–Schmidt inner product, with B_0 = I/√d. State coordinates
x_i = Tr(B_i ρ) are real, and the Born rule is the inner product of
coordinate vectors.

The complex transforms (``state_to_modelparams``, ``modelparams_to_state``,
``covariance_mtx_to_superop``) run on the host in NumPy. The device
transforms keep the JAX package's real-pair form: ρ as an (re, im) pair of
f32 tensors and the real embedding [[re, −im], [im, re]], which has the
spectrum of ρ with doubled multiplicity. The basis holds its real and
imaginary parts as f32 tensors and keeps one copy per device, so a
transform on a CUDA bank copies nothing from the host after its first call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "TomographyBasis",
    "gell_mann_basis",
    "pauli_basis",
    "tensor_product_basis",
]


@dataclass(frozen=True, eq=False)
class TomographyBasis:
    """An orthonormal Hermitian operator basis: ``data`` (d², d, d)
    complex64, subsystem ``dims``, element ``labels``."""

    data: np.ndarray = field(repr=False)
    dims: Tuple[int, ...] = (2,)
    labels: Tuple[str, ...] = ()

    def __post_init__(self):
        arr = np.asarray(self.data, dtype=np.complex64)
        object.__setattr__(self, "data", arr)
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "_re", torch.from_numpy(arr.real.copy()))
        object.__setattr__(self, "_im", torch.from_numpy(arr.imag.copy()))
        object.__setattr__(self, "_on_device", {})
        if not self.labels:
            object.__setattr__(
                self, "labels", tuple(f"B{i}" for i in range(arr.shape[0])))
        else:
            object.__setattr__(self, "labels", tuple(self.labels))

    @property
    def dim(self):
        """Hilbert-space dimension d."""
        return int(np.prod(self.dims))

    @property
    def n_elements(self):
        return self.data.shape[0]

    def __len__(self):
        return self.n_elements

    def __getitem__(self, i):
        return self.data[i]

    def flat(self):
        """(d², d²) matrix whose rows are the flattened basis elements."""
        return self.data.reshape(self.n_elements, -1)

    def re_im(self, device):
        """The basis' (re, im) parts as (d², d, d) f32 tensors on
        ``device``."""
        device = torch.device(device)
        pair = self._on_device.get(device)
        if pair is None:
            pair = (self._re.to(device), self._im.to(device))
            self._on_device[device] = pair
        return pair

    # -- complex transforms (host, NumPy) -----------------------------------

    def state_to_modelparams(self, rho):
        """ρ (…, d, d) complex → real coords (…, d²) f32: x_i = Tr(B_i† ρ)."""
        rho = np.asarray(rho)
        coords = np.einsum("iab,...ab->...i", self.data.conj(), rho)
        return torch.from_numpy(np.ascontiguousarray(coords.real,
                                                     dtype=np.float32))

    def modelparams_to_state(self, x):
        """Coords (…, d²) → complex ρ (…, d, d) = Σ_i x_i B_i."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, dtype=np.float32)
        return np.einsum("...i,iab->...ab", x.astype(np.complex64), self.data)

    def covariance_mtx_to_superop(self, cov):
        """Coordinate covariance → superoperator Σ cov_ij B_i ⊗ B̄_j."""
        if isinstance(cov, torch.Tensor):
            cov = cov.detach().cpu().numpy()
        cov = np.asarray(cov, dtype=np.complex64)
        return np.einsum(
            "ij,iab,jcd->acbd", cov, self.data, self.data.conj()
        ).reshape(self.dim ** 2, self.dim ** 2)

    # -- real-pair transforms (device, batched) ------------------------------

    def real_imag_from_coords(self, x):
        """Coords (…, d²) → (re, im) pair of ρ, each (…, d, d) f32."""
        x = torch.as_tensor(x).to(torch.float32)
        bre, bim = self.re_im(x.device)
        d, n_el = self.dim, self.n_elements
        lead = x.shape[:-1]
        re = (x @ bre.reshape(n_el, d * d)).reshape(lead + (d, d))
        im = (x @ bim.reshape(n_el, d * d)).reshape(lead + (d, d))
        return re, im

    def coords_from_real_imag(self, re, im):
        """(re, im) pair → coords: x_i = Σ Re(B_i)·re + Im(B_i)·im (the real
        part of Tr(B_i† ρ), exact for Hermitian B_i and ρ)."""
        bre, bim = self.re_im(re.device)
        d, n_el = self.dim, self.n_elements
        lead = re.shape[:-2]
        flat_re = re.reshape(lead + (d * d,))
        flat_im = im.reshape(lead + (d * d,))
        return (flat_re @ bre.reshape(n_el, d * d).T
                + flat_im @ bim.reshape(n_el, d * d).T)

    def real_embedding(self, x):
        """Coords → real-symmetric embedding [[re, −im], [im, re]]
        (…, 2d, 2d): the spectrum of ρ with doubled multiplicity."""
        re, im = self.real_imag_from_coords(x)
        top = torch.cat([re, -im], dim=-1)
        bot = torch.cat([im, re], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def coords_from_embedding(self, M):
        """Inverse of ``real_embedding`` (symmetrizing the two blocks)."""
        d = self.dim
        re = 0.5 * (M[..., :d, :d] + M[..., d:, d:])
        im = 0.5 * (M[..., d:, :d] - M[..., :d, d:])
        return self.coords_from_real_imag(re, im)


def gell_mann_basis(dim=2):
    """Normalized generalized Gell-Mann basis with B_0 = I/√d: identity,
    then the diagonal, then the symmetric and antisymmetric elements."""
    mats = [np.eye(dim, dtype=np.complex64) / np.sqrt(dim)]
    labels = ["I"]
    for k in range(1, dim):
        diag = np.zeros(dim)
        diag[:k] = 1.0
        diag[k] = -k
        mats.append(np.diag(diag).astype(np.complex64) / np.sqrt(k * (k + 1)))
        labels.append(f"D{k}")
    for a in range(dim):
        for b in range(a + 1, dim):
            sym = np.zeros((dim, dim), dtype=np.complex64)
            sym[a, b] = sym[b, a] = 1.0 / np.sqrt(2)
            mats.append(sym)
            labels.append(f"S{a}{b}")
            asym = np.zeros((dim, dim), dtype=np.complex64)
            asym[a, b] = -1j / np.sqrt(2)
            asym[b, a] = 1j / np.sqrt(2)
            mats.append(asym)
            labels.append(f"A{a}{b}")
    return TomographyBasis(np.stack(mats), dims=(dim,), labels=tuple(labels))


_PAULIS = {
    "I": np.eye(2, dtype=np.complex64),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex64),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex64),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex64),
}


def pauli_basis(nq=1):
    """Normalized n-qubit Pauli basis {P/√(2ⁿ)}, ordered I, X, Y, Z per
    qubit."""
    mats, labels = [], []
    for combo in product("IXYZ", repeat=nq):
        op = np.array([[1.0]], dtype=np.complex64)
        for ch in combo:
            op = np.kron(op, _PAULIS[ch])
        mats.append(op / np.sqrt(2.0 ** nq))
        labels.append("".join(combo))
    return TomographyBasis(np.stack(mats), dims=(2,) * nq,
                           labels=tuple(labels))


def tensor_product_basis(*bases):
    """Tensor product of bases (Kronecker products of all element pairs)."""
    out = bases[0]
    for nxt in bases[1:]:
        mats = [np.kron(a, b) for a, b in product(out.data, nxt.data)]
        labels = tuple(f"{la}⊗{lb}"
                       for la, lb in product(out.labels, nxt.labels))
        out = TomographyBasis(np.stack(mats), dims=out.dims + nxt.dims,
                              labels=labels)
    return out
