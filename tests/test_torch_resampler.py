"""Port parity for the resamplers (CPU).

Random streams cannot match between the packages (JAX's threefry/rbg
against torch's generators), so the draws are injected: the stratum offset
u0 is computed in JAX from the key the JAX resampler would use and handed
to the port, and the smear noise goes through the ``kernel=`` hook on both
sides. With the draws shared, the Liu–West output agrees to a few f32 ulps
(the moments and the eigh differ in reduction order only).

The segment starts t = ceil(icdf·scale − u0) differ by one in a few places:
XLA on the CPU contracts the product and the difference into one FMA, the
port rounds twice, and the ceiling flips where an integer falls between
the two, for about ulp(n)/2 of the entries. So the starts may differ by at
most 1 in at most 3 + n·ulp(n) entries, and the rows whose pick differs
through them are counted against the same bound instead of compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.resamplers import systematic_resample_indices as j_indices
from qinfer_tpu.resamplers import systematic_segment_starts as j_starts
from qinfer_tpu_torch.ops import resample_expand as tre
from qinfer_tpu_torch.resamplers import (
    multinomial_resample_indices,
    systematic_resample_indices,
    systematic_segment_starts,
)

torch.set_num_threads(2)


def _log_w(n, sharp, seed):
    w = np.random.default_rng(seed).random(n) ** sharp
    return np.log(w / w.sum()).astype(np.float32)


def _u0(key):
    return float(jax.random.uniform(key, ()))


def _flip_bound(n):
    return 3 + int(n * np.spacing(np.float32(n)))


@pytest.mark.parametrize("n,sharp", [(257, 1), (4096, 3), (100_000, 8)])
def test_segment_starts_match_jax(n, sharp):
    """Same u0: equal except a few entries off by one (module docstring)."""
    log_w = _log_w(n, sharp, n)
    key = jax.random.key(n)
    ref = np.asarray(j_starts(key, jnp.asarray(log_w), n)).astype(np.int64)
    out = systematic_segment_starts(torch.from_numpy(log_w), n,
                                    u0=_u0(key)).numpy()
    assert out.dtype == np.int32 and out[0] == 0
    assert np.all(np.diff(out) >= 0)
    diff = np.abs(out.astype(np.int64) - ref)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= _flip_bound(n)


def test_segment_starts_degenerate_and_int_cdf():
    """One particle holding all the mass covers every stratum; the int64
    cumsum equals the JAX package's integer CDF."""
    n = 64
    log_w = torch.full((n,), -float("inf"))
    log_w[17] = 0.0
    starts = systematic_segment_starts(log_w, n, u0=0.3).numpy()
    np.testing.assert_array_equal(starts[:18], 0)
    np.testing.assert_array_equal(starts[18:], n)
    from qinfer_tpu.resamplers import exact_int_cumsum

    q = np.random.default_rng(0).integers(0, 1 << 13, 40_000).astype(np.int32)
    np.testing.assert_array_equal(
        torch.cumsum(torch.from_numpy(q).to(torch.int64), 0).numpy(),
        np.asarray(exact_int_cumsum(jnp.asarray(q))))


def test_systematic_indices_match_jax():
    n = 4096
    log_w = _log_w(n, 3, 1)
    key = jax.random.key(5)
    ref = np.asarray(j_indices(key, jnp.asarray(log_w)))
    out = systematic_resample_indices(torch.from_numpy(log_w),
                                      u0=_u0(key)).numpy()
    starts = systematic_segment_starts(torch.from_numpy(log_w), n,
                                       u0=_u0(key)).numpy()
    np.testing.assert_array_equal(
        out, np.searchsorted(starts, np.arange(n), side="right") - 1)
    assert np.count_nonzero(out != ref) <= _flip_bound(n)


def test_multinomial_indices():
    n = 1000
    log_w = torch.full((n,), -1e30)
    log_w[3] = 0.0
    log_w[7] = 0.0
    idx = multinomial_resample_indices(
        log_w, 500, generator=torch.Generator().manual_seed(0))
    assert idx.shape == (500,)
    assert set(idx.tolist()) <= {3, 7}


def _pair(d, n, seed, **kw):
    """Inputs plus the JAX and port resamplers sharing one noise array."""
    rng = np.random.default_rng(seed)
    locs = (0.5 + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    log_w = _log_w(n, 2, seed)
    noise = rng.standard_normal((n, d)).astype(np.float32)
    j_rs = qi.LiuWestResampler(
        kernel=lambda k, shape: jnp.asarray(noise), **kw)
    t_rs = qt.LiuWestResampler(
        kernel=lambda g, shape: torch.from_numpy(noise), **kw)
    return locs, log_w, j_rs, t_rs


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("use_expand", [None, True])
def test_liu_west_matches_jax_with_injected_draws(d, use_expand):
    n = 4096
    locs, log_w, j_rs, _ = _pair(d, n, 10 + d, postselect=False)
    _, _, _, t_rs = _pair(d, n, 10 + d, postselect=False,
                          use_expand_kernel=use_expand)
    key = jax.random.key(d)
    ref = np.asarray(j_rs(key, None, jnp.asarray(locs), jnp.asarray(log_w)))
    k_idx = jax.random.split(key)[0]
    out = t_rs(None, None, torch.from_numpy(locs), torch.from_numpy(log_w),
               u0=_u0(k_idx)).numpy()
    _assert_close_where_picks_agree(out, ref, log_w, k_idx)


def _assert_close_where_picks_agree(out, ref, log_w, k_idx):
    n = log_w.shape[0]
    same = (np.asarray(j_indices(k_idx, jnp.asarray(log_w)))
            == systematic_resample_indices(torch.from_numpy(log_w),
                                           u0=_u0(k_idx)).numpy())
    assert np.count_nonzero(~same) <= _flip_bound(n)
    np.testing.assert_allclose(out[same], ref[same], rtol=2e-6, atol=2e-7)


def test_postselect_fallback_matches_jax():
    """Noise that leaves some particles invalid on every redraw: both run
    maxiter rounds, then clamp the stragglers with canonicalize."""
    n = 2048
    rng = np.random.default_rng(3)
    locs = rng.random((n, 1)).astype(np.float32)
    log_w = _log_w(n, 1, 3)
    noise = (2.0 * rng.standard_normal((n, 1))).astype(np.float32)
    j_rs = qi.LiuWestResampler(kernel=lambda k, s: jnp.asarray(noise),
                               maxiter=4)
    t_rs = qt.LiuWestResampler(kernel=lambda g, s: torch.from_numpy(noise),
                               maxiter=4)
    key = jax.random.key(2)
    ref = np.asarray(j_rs(key, qi.SimplePrecessionModel(min_freq=0.5),
                          jnp.asarray(locs), jnp.asarray(log_w)))
    out = t_rs(None, qt.SimplePrecessionModel(min_freq=0.5),
               torch.from_numpy(locs), torch.from_numpy(log_w),
               u0=_u0(jax.random.split(key)[0])).numpy()
    assert np.any(out == 0.5) and np.all(out >= 0.5)
    _assert_close_where_picks_agree(out, ref, log_w, jax.random.split(key)[0])


def test_postselect_redraws_only_invalid_particles():
    """The first draw leaves a few invalid particles; the second draw
    (a different noise array) fixes them without touching the rest."""
    n = 1000
    locs = torch.full((n, 1), 0.6)
    log_w = torch.full((n,), -float(np.log(n)))
    first = torch.zeros(n, 1)
    first[:5] = -100.0
    draws = iter([first, torch.zeros(n, 1)])
    calls = []

    def kernel(g, shape):
        calls.append(shape)
        return next(draws)

    # A point cloud: zero_cov_comp gives the smear a unit covariance.
    rs = qt.LiuWestResampler(kernel=kernel, maxiter=8, zero_cov_comp=1.0)
    out = rs(torch.Generator().manual_seed(0),
             qt.SimplePrecessionModel(min_freq=0.0), locs, log_w)
    assert calls == [(n, 1), (n, 1)]  # stopped after the fixing round
    np.testing.assert_allclose(out.numpy(), 0.6, rtol=1e-6)


def test_liu_west_preserves_moments():
    n = 50_000
    rng = np.random.default_rng(8)
    locs = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    log_w = torch.from_numpy(_log_w(n, 1, 8))
    g = torch.Generator().manual_seed(4)
    launches = tre.expand_sorted_segments.launches
    new = qt.LiuWestResampler(postselect=False)(g, None, locs, log_w)
    assert tre.expand_sorted_segments.launches == launches  # CPU: plain
    w = np.exp(log_w.numpy().astype(np.float64))
    w /= w.sum()
    x = locs.numpy().astype(np.float64)
    mu = w @ x
    cov = (w[:, None] * (x - mu)).T @ (x - mu)
    np.testing.assert_allclose(new.numpy().mean(0), mu, atol=0.01)
    np.testing.assert_allclose(np.cov(new.numpy().T), cov, rtol=0.05,
                               atol=2e-3)


def test_h_and_zero_cov_comp():
    rs = qt.LiuWestResampler(a=0.9)
    assert rs._h == pytest.approx(np.sqrt(1 - 0.81))
    assert qt.LiuWestResampler(h=0.3)._h == 0.3
    locs = torch.full((100, 1), 0.4)  # zero covariance
    out = qt.LiuWestResampler(zero_cov_comp=1e-2, postselect=False)(
        torch.Generator().manual_seed(0), None, locs,
        torch.full((100,), -float(np.log(100))))
    assert float(out.std()) > 0.0
