"""Weighted-particle numerics on torch tensors, and host-side helpers.

Counterpart of ``qinfer_tpu/utils.py``, plus ``eigh_batched`` and
``cumsum_rows``. The
tensor functions work on the device of their inputs. The credible-region
geometry (``mvee``, ``in_ellipsoid``, ``ellipsoid_volume``) and the
formatting and record-array helpers run on the host in NumPy f64, as in the
JAX package: they run once per query, not per update.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "log_binomial_coefficient",
    "log_binomial_pdf",
    "binomial_pdf",
    "log_multinomial_pdf",
    "multinomial_pdf",
    "sample_multinomial",
    "binomial",
    "poisson",
    "standard_gamma",
    "normalize_log_weights",
    "log_effective_sample_size",
    "effective_sample_size",
    "particle_mean",
    "particle_covariance_mtx",
    "weighted_moments",
    "weighted_moments_batched",
    "sqrtm_psd",
    "eigh_batched",
    "cumsum_rows",
    "pytree_to_expparams",
    "outer_product",
    "particle_meanfn",
    "mvee",
    "in_ellipsoid",
    "ellipsoid_volume",
    "format_uncertainty",
    "assert_sigfigs_equal",
    "compactspace",
    "uniquify",
    "join_struct_arrays",
    "split_struct_array",
    "to_shaped_outcomes",
]

# cuSOLVER's batched syev (torch 2.11, CUDA 12.8, on an H100) refuses a
# batch of 65536 matrices with CUSOLVER_STATUS_INVALID_VALUE, for every
# size and dtype tried (4, 8, 16; f32, f64); 16384 works.
_EIGH_MAX_BATCH = 1 << 14


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def log_binomial_coefficient(n, k):
    """log C(n, k) via lgamma."""
    n, k = _f32(n), _f32(k)
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0))


def log_binomial_pdf(n, k, p):
    """log Pr(k | n, p) for a binomial.

    xlogy/xlog1py give the limits at p ∈ {0, 1} (0·log 0 = 0); impossible
    outcomes come back as −inf, which the SMC engine clips. Where a
    prefactor is zero its operand is replaced by a harmless one, as the
    JAX package does for finite gradients: the values are unchanged.
    """
    n, k, p = _f32(n), _f32(k), _f32(p)
    p_k = torch.where(k == 0.0, 1.0, p)
    mp_nk = torch.where(n - k == 0.0, 0.0, -p)
    return (log_binomial_coefficient(n, k) + torch.xlogy(k, p_k)
            + torch.special.xlog1py(n - k, mp_nk))


def binomial_pdf(n, k, p):
    """Pr(k | n, p)."""
    return torch.exp(log_binomial_pdf(n, k, p))


# torch.binomial, torch.poisson and torch._standard_gamma on CUDA give each
# thread a Philox stream at the generator's offset and move the offset on
# by a fixed count a call (tens of draws), while a thread draws for
# several elements, some in loops of unbounded length, so the next call on
# the same generator can start inside the last one's draws. On an H100
# (torch 2.11) a two-call binomial ladder at 2^20 rows came out 9 and 14
# standard errors off its means where one call alone was on them
# (chip_smoke.phase_samplers prints both); skipping ahead after each call
# puts every mean within 2 standard errors.
_CUDA_SAMPLER_SKIP = 1 << 24


def _skip_cuda_stream(generator):
    """Move a CUDA generator's Philox offset past the draws of the sampler
    call just made (nothing to do on the CPU's Mersenne twister)."""
    if generator.device.type == "cuda":
        generator.set_offset(generator.get_offset() + _CUDA_SAMPLER_SKIP)


def binomial(count, prob, generator):
    """``torch.binomial(count, prob)`` from ``generator``, whose next call
    then draws afresh."""
    out = torch.binomial(count, prob, generator=generator)
    _skip_cuda_stream(generator)
    return out


def poisson(rate, generator):
    """``torch.poisson(rate)`` from ``generator``, as ``binomial``."""
    out = torch.poisson(rate, generator=generator)
    _skip_cuda_stream(generator)
    return out


def standard_gamma(alpha, generator):
    """Gamma(alpha, 1) draws (``torch._standard_gamma``) from
    ``generator``, as ``binomial``."""
    out = torch._standard_gamma(alpha, generator=generator)
    _skip_cuda_stream(generator)
    return out


def log_multinomial_pdf(ks, ps, eps=1e-12):
    """log Pr(ks | ps) for a multinomial with n = Σ ks: ``ks`` (..., K)
    counts, ``ps`` (..., K) probabilities (clipped to [eps, 1])."""
    ks = _f32(ks)
    ps = torch.clamp(_f32(ps).to(ks.device), eps, 1.0)
    n = torch.sum(ks, dim=-1)
    return (torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(ks + 1.0), dim=-1)
            + torch.sum(ks * torch.log(ps), dim=-1))


def multinomial_pdf(ks, ps):
    return torch.exp(log_multinomial_pdf(ks, ps))


def sample_multinomial(generator, n, ps, shape=()):
    """Multinomial counts (*shape, K) int32 from ``generator``: the ladder
    of K − 1 conditional binomials, count k drawn from what the earlier
    counts left over with probability p_k / (the mass left)."""
    device = generator.device
    ps = _f32(ps).to(device)
    K = ps.shape[-1]
    p_heads = torch.movedim(ps.expand(tuple(shape) + (K,)), -1, 0)
    rem_n = _f32(n).to(device).expand(tuple(shape)).contiguous()
    rem_p = torch.ones(tuple(shape), dtype=torch.float32, device=device)
    draws = []
    for p_k in p_heads[:-1]:
        cond_p = torch.clamp(p_k / torch.clamp(rem_p, min=1e-12), 0.0, 1.0)
        draw = binomial(rem_n, cond_p.contiguous(), generator)
        draws.append(draw)
        rem_n = rem_n - draw
        rem_p = rem_p - p_k
    return torch.stack(draws + [rem_n], dim=-1).to(torch.int32)


def normalize_log_weights(log_w):
    """Normalize so logsumexp(log_w) == 0. Returns (normalized, logsumexp)."""
    lse = torch.logsumexp(log_w, dim=0)
    return log_w - lse, lse


def log_effective_sample_size(log_w):
    """log ESS = −logsumexp(2 · normalized log_w)."""
    log_w_norm, _ = normalize_log_weights(log_w)
    return -torch.logsumexp(2.0 * log_w_norm, dim=0)


def effective_sample_size(log_w):
    return torch.exp(log_effective_sample_size(log_w))


def particle_mean(weights, locations):
    return weights @ locations


def particle_covariance_mtx(weights, locations):
    """Weighted covariance Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ in the centered two-pass
    form: E[xxᵀ] − μμᵀ cancels to negative variances in f32 once the
    posterior is ~1e-3 of the mean scale."""
    mu = particle_mean(weights, locations)
    centered = locations - mu[None, :]
    cov = torch.einsum("i,id,ie->de", weights, centered, centered)
    return 0.5 * (cov + cov.T)


def weighted_moments(log_w, locations):
    """(mean, cov) from log-weights, centered for f32 stability."""
    w = torch.exp(normalize_log_weights(log_w)[0])
    mu = particle_mean(w, locations)
    centered = locations - mu[None, :]
    cov = torch.einsum("i,id,ie->de", w, centered, centered)
    return mu, 0.5 * (cov + cov.T)


def weighted_moments_batched(log_w, locations):
    """(mean (T, D), cov (T, D, D)) of T banks: ``log_w`` (T, N),
    ``locations`` (T, N, D); centered, as ``weighted_moments``."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=1, keepdim=True))
    mu = torch.einsum("tn,tnd->td", w, locations)
    centered = locations - mu[:, None, :]
    cov = torch.einsum("tn,tnd,tne->tde", w, centered, centered)
    return mu, 0.5 * (cov + cov.transpose(1, 2))


def sqrtm_psd(mat, est_error=False):
    """Symmetric PSD square root via eigh, clipping negative eigenvalues;
    ``mat`` is (D, D) or a batch (…, D, D)."""
    vals, vecs = eigh_batched(mat)
    vals_c = torch.clamp(vals, min=0.0)
    root = (vecs * torch.sqrt(vals_c)[..., None, :]) @ vecs.transpose(-1, -2)
    if est_error:
        return root, torch.sum(torch.abs(vals - vals_c), dim=-1)
    return root


def eigh_batched(mat):
    """``torch.linalg.eigh`` of (…, m, m) symmetric matrices, taken in
    chunks of at most 2^14 matrices (each matrix's result is its own)."""
    lead, m = mat.shape[:-2], mat.shape[-1]
    flat = mat.reshape(-1, m, m)
    if flat.shape[0] <= _EIGH_MAX_BATCH:
        return torch.linalg.eigh(mat)
    parts = [torch.linalg.eigh(chunk)
             for chunk in flat.split(_EIGH_MAX_BATCH)]
    evals = torch.cat([p[0] for p in parts])
    evecs = torch.cat([p[1] for p in parts])
    return evals.reshape(lead + (m,)), evecs.reshape(lead + (m, m))


def cumsum_rows(x):
    """Inclusive cumsum of each row of an integer (T, N) tensor, exact.

    One scan over the flattened rows, less each row's start. torch's scan
    along the last axis of a (T, N) tensor gives each row one block, which
    for a few long rows is slow (0.3–0.4 ms a call for 4 rows of 2^18 on
    an H100, ``chip_profile.py``)."""
    flat = torch.cumsum(x.reshape(-1), dim=0).reshape(x.shape)
    before = torch.cat([torch.zeros(1, dtype=flat.dtype, device=flat.device),
                        flat[:-1, -1]])
    return flat - before[:, None]


def pytree_to_expparams(record_array):
    """NumPy record array → expparams (dict of named tensors)."""
    return {name: torch.from_numpy(np.ascontiguousarray(record_array[name]))
            for name in record_array.dtype.names}


def to_shaped_outcomes(outcomes, dtype=torch.int32):
    """Outcomes as a 1-D tensor; integer outcomes cast to ``dtype``."""
    arr = torch.atleast_1d(torch.as_tensor(outcomes))
    if not arr.is_floating_point() and not arr.is_complex():
        arr = arr.to(dtype)
    return arr


def outer_product(vec):
    """vec ⊗ vec."""
    vec = torch.as_tensor(vec)
    return torch.outer(vec, vec)


def particle_meanfn(weights, locations, fn=None):
    """Σᵢ wᵢ f(xᵢ) over the leading axis of f's output."""
    fx = locations if fn is None else fn(locations)
    return torch.tensordot(weights, fx, dims=([0], [0]))


# -- credible-region geometry (host, f64) -------------------------------------

def mvee(points, tol=1e-3, max_iter=1000):
    """Minimum-volume enclosing ellipsoid by Khachiyan's algorithm: (A, c)
    with the ellipsoid {x : (x−c)ᵀ A (x−c) ≤ 1}, every point inside."""
    points = np.asarray(points, dtype=np.float64)
    N, d = points.shape
    Q = np.column_stack((points, np.ones(N))).T  # (d+1, N)
    u = np.ones(N) / N
    for _ in range(max_iter):
        X = Q @ np.diag(u) @ Q.T
        M = np.einsum("ji,jk,ki->i", Q, np.linalg.inv(X), Q)
        j = int(np.argmax(M))
        # Khachiyan's stopping rule: max_i M_i ≤ (1+tol)(d+1).
        if M[j] <= (1.0 + tol) * (d + 1.0):
            break
        step = (M[j] - d - 1.0) / ((d + 1.0) * (M[j] - 1.0))
        u = (1.0 - step) * u
        u[j] += step
    c = points.T @ u
    A = np.linalg.inv(points.T @ np.diag(u) @ points - np.outer(c, c)) / d
    # Khachiyan converges to first order: scale A so that every point is
    # inside (enclosure is the contract; optimality is within tol).
    diff = points - c
    max_val = np.einsum("id,de,ie->i", diff, A, diff).max()
    if max_val > 1.0:
        A = A / max_val
    return A, c


def in_ellipsoid(x, A, c):
    """Whether the points x lie in the ellipsoid (A, c); a bool for one
    point."""
    x = np.atleast_2d(np.asarray(x))
    d = x - c[None, :]
    res = np.einsum("id,de,ie->i", d, A, d) <= 1.0
    return res if res.size > 1 else bool(res[0])


def ellipsoid_volume(A=None, invA=None):
    """Volume of the ellipsoid xᵀAx ≤ 1."""
    from scipy.special import gamma

    if invA is None:
        if A is None:
            raise ValueError("Must pass either A or invA.")
        invA = np.linalg.inv(A)
    d = invA.shape[0]
    return (np.pi ** (d / 2.0) / gamma(d / 2.0 + 1)) * np.sqrt(
        np.linalg.det(invA))


# -- formatting and record arrays (host) -------------------------------------

def format_uncertainty(value, uncertainty, scinotn_break=4):
    """"value ± uncertainty" to the uncertainty's first significant figure,
    in scientific notation from ``scinotn_break`` orders of magnitude."""
    if uncertainty == 0:
        return str(value)
    mag_unc = int(np.floor(np.log10(abs(uncertainty))))
    mag_val = int(np.floor(np.log10(abs(value)))) if value != 0 else 0
    if abs(mag_val) < scinotn_break:
        if mag_unc >= 0:
            return "{0:.0f} ± {1:.0f}".format(value, uncertainty)
        prec = -mag_unc
        return "{0:.{2}f} ± {1:.{2}f}".format(value, uncertainty, prec)
    scaled_val = value * 10.0 ** (-mag_val)
    scaled_unc = uncertainty * 10.0 ** (-mag_val)
    prec = max(mag_val - mag_unc, 0)
    return "({0:.{3}f} ± {1:.{3}f}) × 10^{2}".format(
        scaled_val, scaled_unc, mag_val, prec)


def assert_sigfigs_equal(x, y, sigfigs=3):
    """Assert that x and y agree to ``sigfigs`` significant figures."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    mag = np.floor(np.log10(np.maximum(np.abs(x), np.abs(y))))
    scale = 10.0 ** (mag - sigfigs + 1)
    np.testing.assert_array_equal(np.round(x / scale), np.round(y / scale))


def compactspace(scale, n):
    """n points spread over the reals by the arctanh compactification."""
    interior = np.linspace(-1.0, 1.0, n + 2)[1:-1]
    return scale * np.arctanh(interior)


def uniquify(seq):
    """Order-preserving deduplication."""
    seen = set()
    return [x for x in seq if not (x in seen or seen.add(x))]


def join_struct_arrays(arrays):
    """Structured arrays of one shape joined field-wise into one."""
    dtype = []
    for a in arrays:
        dtype.extend(a.dtype.descr)
    out = np.empty(arrays[0].shape, dtype=dtype)
    for a in arrays:
        for name in a.dtype.names:
            out[name] = a[name]
    return out


def split_struct_array(array, fields):
    """A structured array split into (the named fields, the rest)."""
    fields = list(fields)
    rest = [n for n in array.dtype.names if n not in fields]

    def take(names):
        dtype = [d for d in array.dtype.descr if d[0] in names]
        out = np.empty(array.shape, dtype=dtype)
        for n in names:
            out[n] = array[n]
        return out

    return take(fields), take(rest)
