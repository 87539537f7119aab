"""Port parity for kernel B2, the systematic-resampling expand (CPU).

The cases of the JAX package's expand tests (ragged n, degenerate weights,
skew at the TPU chunk edges 8191/16383/16384, shifted windows, several
columns, the fused affine) go through the port's plain version and, on the
same starts, through the JAX Pallas kernel in interpret mode (n ≤ 16384,
where interpret mode is cheap) or the numpy searchsorted oracle. Picks
must be exactly equal; with the affine, exactly equal to numpy's rounding
and within one ulp of the JAX kernel's (see ``_check``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qinfer_tpu.ops.resample_expand import expand_sorted_segments as j_expand
from qinfer_tpu.resamplers import systematic_segment_starts as j_starts
from qinfer_tpu_torch.ops import resample_expand as tre
from qinfer_tpu_torch.resamplers import (
    systematic_resample_indices,
    systematic_segment_starts,
)

torch.set_num_threads(2)

JAX_MAX_N = 16384


def _starts_from_weights(w, u0):
    n = w.shape[0]
    t = np.ceil(n * np.cumsum(w / w.sum()) - u0).astype(np.int64)
    return np.maximum.accumulate(
        np.maximum(np.concatenate([[0], t[:-1]]), 0)).astype(np.int32)


def _oracle(starts, vals, n_out):
    idx = np.searchsorted(starts, np.arange(n_out), side="right") - 1
    return vals[idx]


def _check(starts, vals, n_out=None, scale=None, shift=None):
    """Port pick == oracle, and == the JAX kernel where it is cheap."""
    n_out = starts.shape[0] if n_out is None else n_out
    launches = tre.expand_sorted_segments.launches
    out = tre.expand_sorted_segments(
        torch.from_numpy(starts), torch.from_numpy(vals), n_out=n_out,
        scale=scale, shift=shift).numpy()
    assert tre.expand_sorted_segments.launches == launches  # CPU: plain
    if scale is None and shift is None:
        np.testing.assert_array_equal(out, _oracle(starts, vals, n_out))
    if starts.shape[0] <= JAX_MAX_N:
        ref = np.asarray(j_expand(
            jnp.asarray(starts), jnp.asarray(vals), n_out=n_out,
            interpret=True,
            scale=None if scale is None else np.float32(scale),
            shift=None if shift is None else jnp.asarray(shift)))
        if scale is None and shift is None:
            np.testing.assert_array_equal(out, ref)
        else:
            # XLA on the CPU contracts the kernel's x·a + b into one FMA;
            # the port rounds the product, then the sum (as numpy does,
            # checked exactly by the caller): one ulp apart, the JAX
            # package's own affine tolerance.
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    return out


@pytest.mark.parametrize("n", [257, 1000, 5000, 16384, 16385, 40000])
def test_expand_matches_searchsorted(n):
    rng = np.random.default_rng(n)
    starts = _starts_from_weights(rng.random(n) ** 3, 0.37)
    _check(starts, rng.standard_normal(n).astype(np.float32))


def test_expand_degenerate_weights():
    n = 512
    starts = np.full(n, n, np.int32)
    starts[:18] = 0  # particles 0..17 start at 0; 17 covers everything
    out = _check(starts, np.arange(n, dtype=np.float32))
    np.testing.assert_array_equal(out, np.full(n, 17.0))


def test_expand_one_particle_covers_everything():
    n = 300
    starts = np.full(n, n, np.int32)
    starts[0] = 0
    out = _check(starts, np.arange(n, dtype=np.float32) + 5.0)
    np.testing.assert_array_equal(out, np.full(n, 5.0))


@pytest.mark.parametrize(
    "n,heavy_at",
    [(16384, 0), (16384, 8191), (16384, 16383)]
    + [(24571, h) for h in (0, 8191, 8192, 9000, 16383, 16384, 24000, 24570)],
)
def test_expand_extreme_skew(n, heavy_at):
    """One particle holds ~all mass, at and around the TPU kernel's chunk
    edges (8191/16383/16384)."""
    w = np.full(n, 1e-9)
    w[heavy_at] = 1.0
    starts = _starts_from_weights(w, 0.5)
    vals = np.random.default_rng(heavy_at).standard_normal(n).astype(
        np.float32)
    out = _check(starts, vals)
    assert np.mean(out == vals[heavy_at]) > 0.99


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_expand_shifted_window_fuzz(seed):
    """The sharded caller's pattern: n_out < n_in, starts shifted by the
    window origin and clamped at 0."""
    rng = np.random.default_rng(seed)
    n_in = int(rng.integers(3000, 40000))
    w = rng.random(n_in) ** [1, 3, 8][seed % 3]
    starts = _starts_from_weights(w, rng.random())
    n_out = int(rng.integers(256, n_in // 2))
    s0 = int(rng.integers(0, n_in - n_out))
    shifted = np.maximum(starts - s0, 0).astype(np.int32)
    _check(shifted, rng.standard_normal(n_in).astype(np.float32), n_out=n_out)


def test_expand_multicolumn_on_jax_starts():
    n = 2048
    rng = np.random.default_rng(1)
    w = rng.random(n)
    log_w = np.log(w / w.sum()).astype(np.float32)
    starts = np.asarray(j_starts(jax.random.key(0), jnp.asarray(log_w), n))
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    out = _check(starts.astype(np.int32), vals)
    assert out.shape == (n, 3)


def test_expand_fused_affine():
    """scale/shift at the write equal the plain pick followed by the affine
    (product rounded, then the sum) — and the JAX kernel's output stage."""
    n = 4096
    rng = np.random.default_rng(7)
    starts = _starts_from_weights(rng.random(n), 0.2)
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    a = 0.98
    shift = np.float32(1.0 - a) * np.array([0.3, -1.2], np.float32)
    out = _check(starts, vals, scale=a, shift=shift)
    plain = _oracle(starts, vals, n)
    np.testing.assert_array_equal(out, plain * np.float32(a) + shift)


def test_systematic_expand_equals_gather():
    n = 2048
    rng = np.random.default_rng(4)
    log_w = torch.from_numpy(np.log(rng.random(n)).astype(np.float32))
    vals = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    out = tre.systematic_expand(log_w, vals, u0=0.61)
    idx = systematic_resample_indices(log_w, u0=0.61)
    np.testing.assert_array_equal(out.numpy(), vals[idx].numpy())
    # u0 drawn from a generator is reproducible per seed.
    a = tre.systematic_expand(log_w, vals,
                              generator=torch.Generator().manual_seed(3))
    b = tre.systematic_expand(log_w, vals,
                              generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_float_starts_are_taken_as_int32():
    n = 1000
    rng = np.random.default_rng(2)
    starts = _starts_from_weights(rng.random(n), 0.5)
    vals = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    a = tre.expand_sorted_segments(torch.from_numpy(starts), vals)
    b = tre.expand_sorted_segments(
        torch.from_numpy(starts.astype(np.float32)), vals)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_n_out_bound_raises():
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        tre.expand_sorted_segments(starts, torch.zeros(4), n_out=1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        systematic_segment_starts(torch.zeros(4), 1 << 24, u0=0.5)
