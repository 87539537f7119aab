"""The validity test of d-level tomography: wrapper and plain version.

A row of coordinates x (d², in an orthonormal Hermitian basis) is a state
when ρ = Σ_i x_i B_i has no eigenvalue below −psd_tol and its trace is one
(x₀ = 1/√d; at most that for subnormalised states). ``psd_valid_plain``
tests it in plain PyTorch: ρ's real and imaginary parts by two matrix
products, then an LDLᴴ factorization of ρ + psd_tol·I (``_psd_via_ldl``).
On a CUDA tensor ``psd_valid`` makes the same test in one launch of the
hand-written kernel in ``csrc/psd_valid.cu`` (its header says what bounds
it and how it is laid out), for d = 3 and 4 (``psd_valid_route``); on a CPU
tensor it runs the plain version. The kernel takes the same decisions on
every row but those within rounding of the threshold. Its launches are
counted on ``psd_valid.launches`` and, while a profiler records, its rows
on the program's counter ``ops.psd_valid.rows``. A failed build or launch
raises: nothing falls back.

The JAX package tests the characteristic polynomial of the real embedding
instead (no Pallas kernel), which f32 cannot decide near low-rank states.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from ..profiling import count

__all__ = ["psd_valid", "psd_valid_plain", "psd_valid_route", "trace_ok"]

KERNEL_DIMS = (3, 4)  # the d that csrc/psd_valid.cu is built for


def _psd_via_ldl(re, im, tol):
    """All eigenvalues of the Hermitian ρ = re + i·im (…, d, d) ≥ −tol,
    without an eigendecomposition.

    eig(ρ) ≥ −tol ⟺ ρ + tol·I ⪰ 0, which (up to its boundary) holds iff
    every pivot of the LDLᴴ factorization of ρ + tol·I (Cholesky without
    the square roots, no pivoting) is > 0. d elementwise steps over the
    batch, each a rank-one Schur complement. The factorization is
    backward stable: rounding moves the threshold by about d·eps·‖ρ‖
    (≈ 3e-7 in f32 for a state). A test of the characteristic polynomial's
    coefficients (Newton's identities over power sums) is not: near a
    low-rank state they are products of small eigenvalues, and f32 gives
    them no sign.
    """
    d = re.shape[-1]
    ar = re + tol * torch.eye(d, dtype=re.dtype, device=re.device)
    ai = im
    ok = ar[..., 0, 0] > 0
    for _ in range(d - 1):
        p = ar[..., 0, 0]
        inv = (1.0 / torch.where(p > 0, p, torch.ones_like(p)))[..., None,
                                                                 None]
        cr, ci = ar[..., 1:, :1], ai[..., 1:, :1]  # the column below p
        crt, cit = cr.transpose(-1, -2), ci.transpose(-1, -2)
        # A ← A − c·cᴴ/p on the trailing block: c_i·conj(c_j) =
        # (cr_i·cr_j + ci_i·ci_j) + i·(ci_i·cr_j − cr_i·ci_j).
        ar = ar[..., 1:, 1:] - (cr * crt + ci * cit) * inv
        ai = ai[..., 1:, 1:] - (ci * crt - cr * cit) * inv
        ok = ok & (ar[..., 0, 0] > 0)
    return ok


def _trace_bounds(dim, allow_subnormalized):
    """(target 1/√d, bound): x₀ ≤ bound for subnormalised states, else
    |x₀ − target| < bound."""
    target = 1.0 / math.sqrt(dim)
    return target, (target + 1e-5 if allow_subnormalized else 1e-4)


def trace_ok(x0, dim, allow_subnormalized):
    """The trace test on the first coordinates ``x0`` (N,)."""
    target, bound = _trace_bounds(dim, allow_subnormalized)
    if allow_subnormalized:
        return x0 <= bound
    return torch.abs(x0 - target) < bound


def psd_valid_plain(coords, basis, psd_tol, allow_subnormalized=False):
    """Plain PyTorch version of the kernel on (N, d²) coordinates in
    ``basis``: ρ ⪰ −psd_tol·I and the trace test. Returns (N,) bool."""
    re, im = basis.real_imag_from_coords(coords)
    return (_psd_via_ldl(re, im, psd_tol)
            & trace_ok(coords[:, 0], basis.dim, allow_subnormalized))


def psd_valid_route(device_type, dim):
    """Whether a tomography model of dimension ``dim`` tests a bank on
    ``device_type`` with the kernel: on CUDA for d = 3 and 4. Qubits keep
    their closed form; d ≥ 5 and CPU banks keep the plain version."""
    return device_type == "cuda" and dim in KERNEL_DIMS


@functools.lru_cache(maxsize=None)
def _host_basis(basis):
    """The basis' real then imaginary parts, (2, d², d, d) f32 on the host:
    the kernel's parameter."""
    return torch.stack(basis.re_im("cpu")).contiguous()


def _psd_valid_cuda(coords, basis, psd_tol, allow_subnormalized):
    """The kernel on (N, d²) f32 coordinates with unit column stride (rows
    at any stride). Raises ValueError on what it does not take."""
    dim = basis.dim
    if dim not in KERNEL_DIMS:
        raise ValueError(f"the validity kernel takes d = 3 or 4; got d = "
                         f"{dim}")
    if (coords.dtype != torch.float32 or coords.ndim != 2
            or coords.shape[1] != basis.n_elements or coords.stride(1) != 1):
        raise ValueError(f"the validity kernel takes f32 (N, {dim * dim}) "
                         f"coordinates with unit column stride; got "
                         f"{coords.dtype} {tuple(coords.shape)} with strides "
                         f"{coords.stride()}")
    n = coords.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=coords.device)
    if n == 0:
        return out
    target, bound = _trace_bounds(dim, allow_subnormalized)
    lib, _ = _build.library()
    with torch.cuda.device(coords.device):
        err = lib.qt_psd_valid(
            coords.data_ptr(), n, coords.stride(0), dim,
            _host_basis(basis).data_ptr(), float(psd_tol), target, bound,
            int(bool(allow_subnormalized)), out.data_ptr(),
            torch.cuda.current_stream(coords.device).cuda_stream,
        )
    _build.check(err, "qt_psd_valid")
    psd_valid.launches += 1
    count("ops.psd_valid.rows", n)
    return out


def psd_valid(coords, basis, psd_tol, allow_subnormalized=False):
    """Which rows of ``coords`` (N, d²) in ``basis`` are states (module
    docstring). A CUDA tensor takes the kernel (d = 3, 4; else ValueError),
    a CPU tensor the plain version. Returns (N,) bool."""
    if not coords.is_cuda:
        return psd_valid_plain(coords, basis, psd_tol, allow_subnormalized)
    coords = coords.to(torch.float32)
    if coords.stride(1) != 1:
        coords = coords.contiguous()
    return _psd_valid_cuda(coords, basis, psd_tol, allow_subnormalized)


psd_valid.launches = 0
