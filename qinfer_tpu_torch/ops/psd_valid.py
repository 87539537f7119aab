"""The validity test of d-level tomography: wrapper and plain version.

A row of coordinates x (d², in an orthonormal Hermitian basis) is a state
when ρ = Σ_i x_i B_i has no eigenvalue below −psd_tol and its trace is one
(x₀ = 1/√d; at most that for subnormalised states). ``psd_valid_plain``
tests it in plain PyTorch: ρ's real and imaginary parts by two matrix
products, then an LDLᴴ factorization of ρ + psd_tol·I (``_psd_via_ldl``).
On a CUDA tensor ``psd_valid`` makes the same test in one launch of the
hand-written kernel in ``csrc/psd_valid.cu`` (its header says what bounds
it and how it is laid out), for d = 3, 4 and 8 (``psd_valid_route``; d = 8
is three qubits); on a CPU tensor it runs the plain version. The kernel
takes the same decisions on every row but those within rounding of the
threshold. Its launches are counted on ``psd_valid.launches`` and, while a
profiler records, its rows on the program's counter ``ops.psd_valid.rows``.
A failed build or launch raises: nothing falls back.

``psd_redraw`` is a redraw round of Liu–West postselection on a CUDA bank
in one launch of the same file's second kernel: on the rows still invalid
it smears, makes the same test and merges, and counts the rows left
invalid on the device. Its plain version is the resampler's masked chain
(``LiuWestResampler._postselect``); its rows count on
``ops.psd_valid.rows`` too, its launches on ``psd_redraw.launches``.

The JAX package tests the characteristic polynomial of the real embedding
instead (no Pallas kernel), which f32 cannot decide near low-rank states.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from ..profiling import count

__all__ = ["psd_valid", "psd_valid_plain", "psd_valid_route", "psd_redraw",
           "trace_ok"]

KERNEL_DIMS = (3, 4, 8)  # the d that csrc/psd_valid.cu is built for


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
    ``device_type`` with the kernel: on CUDA for d = 3, 4 and 8. Qubits
    keep their closed form; d = 5–7, d > 8 and CPU banks keep the plain
    version."""
    return device_type == "cuda" and dim in KERNEL_DIMS


@functools.lru_cache(maxsize=None)
def _host_basis(basis):
    """The basis' real then imaginary parts, (2, d², d, d) f32 on the host:
    the kernels' basis, which the launch lays out as the kernel reads it."""
    return torch.stack(basis.re_im("cpu")).contiguous()


def _psd_valid_cuda(coords, basis, psd_tol, allow_subnormalized):
    """The kernel on (N, d²) f32 coordinates with unit column stride (rows
    at any stride). Raises ValueError on what it does not take."""
    dim = basis.dim
    if dim not in KERNEL_DIMS:
        raise ValueError(f"the validity kernel takes d = 3, 4 or 8; got "
                         f"d = {dim}")
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
    docstring). A CUDA tensor takes the kernel (d = 3, 4, 8; else
    ValueError), a CPU tensor the plain version. Returns (N,) bool."""
    if not coords.is_cuda:
        return psd_valid_plain(coords, basis, psd_tol, allow_subnormalized)
    coords = coords.to(torch.float32)
    if coords.stride(1) != 1:
        coords = coords.contiguous()
    return _psd_valid_cuda(coords, basis, psd_tol, allow_subnormalized)


psd_valid.launches = 0


def psd_redraw(locs, ok, centers, root, noise, n_tested, rows, basis,
               psd_tol, allow_subnormalized=False):
    """One redraw round on the rows of ``locs`` (M, d²) still invalid, in
    one launch: for each, x = centers[i] + root·noise[i], the module's test
    of x, and where x is a state ``locs[i] = x`` and ``ok[i] = True`` (both
    in place). ``rows``: the round's rows, an int32 list of ``n_tested``
    row indices (the last round's), or None for every row that ``ok`` (M,)
    marks invalid, ``n_tested`` of them (known on the host; they count on
    ``ops.psd_valid.rows``). ``root`` is (d², d²) for the bank, or (T, d²,
    d²) for T banks of M/T rows each. CUDA tensors only, on one device (d =
    3, 4, 8, f32, ``locs`` and ``ok`` contiguous; else ValueError). Returns
    (the rows still invalid: a 0-d int32 on the device, for the round's one
    host read; an int32 tensor whose first that many entries list them, in
    no order, for the next round's ``rows``)."""
    if not locs.is_cuda:
        raise ValueError("the redraw kernel takes CUDA tensors; its plain "
                         "version is the resampler's masked chain")
    return _psd_redraw_cuda(locs, ok, centers, root, noise, n_tested, rows,
                            basis, psd_tol, allow_subnormalized)


def _psd_redraw_cuda(locs, ok, centers, root, noise, n_tested, rows, basis,
                     psd_tol, allow_subnormalized):
    """``psd_redraw``'s launch, on tensors of one device."""
    dim, n_el = basis.dim, basis.n_elements
    m = locs.shape[0]
    banks = 1 if root.ndim == 2 else root.shape[0]
    centers, root, noise = (t.contiguous() for t in (centers, root, noise))
    if dim == 8:  # the d = 8 round reads S and ε as float4
        root, noise = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (root, noise))
    tensors = (locs, ok, centers, root, noise) + (
        () if rows is None else (rows,))
    if (dim not in KERNEL_DIMS
            or any(t.device != locs.device for t in tensors)
            or any(t.dtype != torch.float32
                   for t in (locs, centers, root, noise))
            or not (locs.is_contiguous() and ok.is_contiguous())
            or any(t.shape != (m, n_el) for t in (locs, centers, noise))
            or root.shape[-2:] != (n_el, n_el) or root.ndim > 3 or m % banks
            or ok.shape != (m,) or ok.dtype != torch.bool
            or (rows is not None and (rows.dtype != torch.int32
                                      or rows.shape != (n_tested,)
                                      or not rows.is_contiguous()))):
        raise ValueError(
            f"the redraw kernel takes d = 3, 4 or 8 and contiguous f32 CUDA "
            f"rows (M, {n_el}) with a root ({n_el}, {n_el}) or (T, {n_el}, "
            f"{n_el}), a bool mask (M,) and an int32 list of the "
            f"{n_tested} rows or None; got d = {dim}, "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}"
                        for t in tensors))
    left = torch.empty((), dtype=torch.int32, device=locs.device)
    # Room for every row the round walks, whatever ``n_tested`` says.
    rows_left = torch.empty(m if rows is None else n_tested,
                            dtype=torch.int32, device=locs.device)
    target, bound = _trace_bounds(dim, allow_subnormalized)
    lib, _ = _build.library()
    with torch.cuda.device(locs.device):
        err = lib.qt_psd_redraw(
            locs.data_ptr(), ok.data_ptr(), centers.data_ptr(),
            root.data_ptr(), noise.data_ptr(),
            None if rows is None else rows.data_ptr(),
            m if rows is None else n_tested, m // banks, dim,
            _host_basis(basis).data_ptr(), float(psd_tol), target, bound,
            int(bool(allow_subnormalized)), rows_left.data_ptr(),
            left.data_ptr(),
            torch.cuda.current_stream(locs.device).cuda_stream,
        )
    _build.check(err, "qt_psd_redraw")
    psd_redraw.launches += 1
    count("ops.psd_valid.rows", n_tested)
    return left, rows_left


psd_redraw.launches = 0
