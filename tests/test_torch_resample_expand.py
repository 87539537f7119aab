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


# -- the merge-path form's partition, modelled in numpy -------------------------

MERGE_TILE = 2048  # kMergeTile in csrc/resample_expand.cu


def _merge_split(starts, n_out, d):
    """The starts among the first d items of the merge of the starts with
    the rows 0…n_out−1 (a start equal to i before row i): the first k with
    min(starts[k], n_out) + k ≥ d, by the kernel's 32-ary rounds."""
    n_in = starts.shape[0]
    key = np.minimum(starts.astype(np.int64), n_out) + np.arange(n_in)
    a, b = max(0, d - n_out), min(d, n_in)
    while a < b:
        step = (b - a + 31) // 32
        probes = a + step * np.arange(32)
        c = int(np.sum((probes < b) & (key[np.minimum(probes, n_in - 1)] < d)))
        if c > 0:
            a, b = a + (c - 1) * step + 1, min(a + c * step, b)
        else:
            b = a
    return a


def _merge_path_expand(starts, vals, n_out, tile):
    """The merge-path form: tile x merges items [x·tile, (x + 1)·tile),
    its starts [a0, a1) and rows [b0, b1); each window start that ends its
    run of equal starts marks its row, and each row takes the last mark at
    or before it (a0 − 1 if none, clamped at 0). Returns the output and the
    tiles' (a0, a1, b0, b1)."""
    n_in = starts.shape[0]
    out = np.full((n_out,) + vals.shape[1:], np.nan, vals.dtype)
    tiles = []
    for d0 in range(0, n_in + n_out, tile):
        d1 = min(d0 + tile, n_in + n_out)
        a0, a1 = _merge_split(starts, n_out, d0), _merge_split(starts, n_out, d1)
        b0, b1 = d0 - a0, d1 - a1
        window = starts[a0:a1].astype(np.int64)
        source = np.full(b1 - b0, -1, np.int64)
        ends = np.append(window[1:] != window[:-1], True)
        rows = window - b0
        mark = ends & (rows < b1 - b0)
        source[rows[mark]] = a0 + np.flatnonzero(mark)
        source = np.maximum.accumulate(np.maximum(source, max(a0 - 1, 0)))
        out[b0:b1] = vals[source]
        tiles.append((a0, a1, b0, b1))
    return out, tiles


def _kind_starts(kind, n, rng):
    if kind == "random":
        w = rng.random(n) ** 3
    elif kind == "degenerate":  # all mass on particle 17
        w = np.zeros(n)
        w[17] = 1.0
    else:  # single heavy particle over a 1e-9 floor
        w = np.full(n, 1e-9)
        w[n // 2 + 1] = 1.0
    return _starts_from_weights(w, 0.37)


@pytest.mark.parametrize("tile", [7, 64, MERGE_TILE])
@pytest.mark.parametrize("window", ["full", "shifted"])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("n", [257, 16385])
def test_merge_path_model_matches_plain(n, kind, window, tile):
    """The merge-path partition picks what expand_plain picks, with n_out =
    n_in and with a shifted window n_out < n_in (starts beyond n_out); each
    tile holds at most ``tile`` starts and rows, whatever the weights, and
    the tiles' rows cover [0, n_out) once, in order."""
    rng = np.random.default_rng(n)
    starts = _kind_starts(kind, n, rng)
    n_out = n
    if window == "shifted":
        n_out = n // 2 + 3
        starts = np.maximum(starts - n // 5, 0).astype(np.int32)
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    out, tiles = _merge_path_expand(starts, vals, n_out, tile)
    plain = tre.expand_plain(torch.from_numpy(starts), torch.from_numpy(vals),
                             n_out).numpy()
    np.testing.assert_array_equal(out, plain)
    assert all(a1 - a0 <= tile and b1 - b0 <= tile
               for a0, a1, b0, b1 in tiles)
    assert [t[2] for t in tiles[1:]] == [t[3] for t in tiles[:-1]]
    assert (tiles[0][2], tiles[-1][3]) == (0, n_out)
    assert (tiles[0][0], tiles[-1][1]) == (0, n)


@pytest.mark.parametrize("kind", ["degenerate", "single_heavy"])
def test_merge_path_tiles_cut_runs_of_equal_starts(kind):
    """Tiles whose edge falls inside a run of equal starts (thousands of
    particles with no offspring) still pick exactly."""
    n = 16385
    starts = _kind_starts(kind, n, np.random.default_rng(0))
    vals = np.arange(n, dtype=np.float32)
    out, tiles = _merge_path_expand(starts, vals, n, 64)
    cuts = [a0 for a0, _, _, _ in tiles if 0 < a0 < n
            and starts[a0 - 1] == starts[a0]]
    assert len(cuts) > 10
    np.testing.assert_array_equal(out, _oracle(starts, vals, n))


BANK_PHASE = 1 << 14  # starts a staging phase copies (kStagePhase)


def _bank_staged(starts, r1, head):
    """How many starts a bank-form block stages for rows below r1 (the
    kernel's stage_starts): ``head`` single loads up to the first 16-byte
    boundary, then phases of BANK_PHASE starts in whole 16-byte groups,
    ending at the first phase whose last start is at or past r1."""
    n_in = starts.shape[0]
    head = min(head, n_in)
    n4 = (n_in - head) // 4
    q1 = 0
    while True:
        q1 = min(q1 + BANK_PHASE // 4, n4)
        if q1 == n4:
            return n_in
        if starts[head + 4 * q1 - 1] >= r1:
            return head + 4 * q1


def _bank_sources(window, n_in, r0, r1):
    """The scanned tile's sources of rows [r0, r1) from the staged starts:
    each staged start in [r0, r1) that ends its run of equal starts marks
    its row, the last start below r0 (the one whose successor is not below
    r0) fills the rows before the first mark (0 if none), and each row
    takes the last mark at or before it. Its thread layout (four rows a
    thread, a warp scan, the warps' maxima) orders the same maxima."""
    m = window.shape[0]
    succ = np.append(window[1:], window[-1] + 1 if m == n_in else r1)
    last = np.arange(m) + 1 == n_in
    ends = last | (succ != window)
    mark = (window >= r0) & (window < r1) & ends
    below = (window < r0) & (last | (succ >= r0))
    assert below.sum() <= 1
    before = int(np.flatnonzero(below)[0]) if below.any() else 0
    source = np.full(r1 - r0, -1, np.int64)
    source[window[mark] - r0] = np.flatnonzero(mark)
    return np.maximum.accumulate(np.maximum(source, before))


def _bank_expand(starts, vals, n_out, tiles, head=0):
    """The bank form: tile x writes rows [r0, r1) = [x·R, …), R =
    ⌈n_out / tiles⌉ ≤ BANK_MAX_ROWS. It stages starts [0, m)
    (``_bank_staged``); a tile of at most BANK_THREADS rows searches each
    row's source in them (a thread a row), a larger one marks and scans
    (``_bank_sources``). Returns the output and each tile's (r0, r1, m)."""
    n_in = starts.shape[0]
    rows_per_tile = -(-n_out // tiles)
    assert rows_per_tile <= tre.BANK_MAX_ROWS
    out = np.full((n_out,) + vals.shape[1:], np.nan, vals.dtype)
    tiles_seen = []
    for r0 in range(0, n_out, rows_per_tile):
        r1 = min(r0 + rows_per_tile, n_out)
        m = _bank_staged(starts, r1, head)
        window = starts[:m].astype(np.int64)
        if rows_per_tile <= tre.BANK_THREADS:
            count = np.searchsorted(window, np.arange(r0, r1), side="right")
            source = np.maximum(count - 1, 0)
        else:
            source = _bank_sources(window, n_in, r0, r1)
        out[r0:r1] = vals[source]
        tiles_seen.append((r0, r1, m))
    return out, tiles_seen


def _bank_case(kind, n, window, rng):
    starts = _kind_starts(kind, n, rng)
    n_out = n
    if window == "shifted":
        n_out = n // 2 + 3
        starts = np.maximum(starts - n // 5, 0).astype(np.int32)
    return starts, n_out


@pytest.mark.parametrize("head", [0, 3])
@pytest.mark.parametrize("rows", [100, 256, 513, 2048, None])
@pytest.mark.parametrize("window", ["full", "shifted"])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("n", [257, 2000, 5001, 16385])
def test_bank_form_model_matches_plain(n, kind, window, rows, head):
    """The bank form's staging and its searched (≤ 512 rows) or scanned
    tiles pick what expand_plain picks, bit for bit: tiles of ``rows``
    rows (None: one bank of up to 2048 rows, else the wrapper's tiling of
    a single bank), n_out = n_in and a shifted window n_out < n_in, any
    alignment of the bank's starts. Each tile stages the starts below its
    rows' end, rounded up to a phase, and the tiles' rows cover [0, n_out)
    once, in order."""
    rng = np.random.default_rng(n + (rows or 0))
    starts, n_out = _bank_case(kind, n, window, rng)
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    if rows is None:
        tiles = (-(-n_out // tre.BANK_MAX_ROWS) if n_out > tre.BANK_MAX_ROWS
                 else 1)
    else:
        tiles = -(-n_out // rows)
    out, tiles_seen = _bank_expand(starts, vals, n_out, tiles, head)
    plain = tre.expand_plain(torch.from_numpy(starts), torch.from_numpy(vals),
                             n_out).numpy()
    np.testing.assert_array_equal(out, plain)
    assert [t[0] for t in tiles_seen[1:]] == [t[1] for t in tiles_seen[:-1]]
    assert (tiles_seen[0][0], tiles_seen[-1][1]) == (0, n_out)
    for _, r1, m in tiles_seen:
        need = int(np.searchsorted(starts, r1 - 1, side="right"))
        assert need <= m and (m == n or m < need + BANK_PHASE)


@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("n", [tre.BANK_CAP, tre.BANK_CAP - 3])
def test_bank_form_model_at_the_cap(n, kind):
    """At the cap the bank stages in two phases, and a tile whose rows'
    starts all lie in the first ends its staging there."""
    rng = np.random.default_rng(7)
    staged = []
    for window in ("full", "shifted"):
        starts, n_out = _bank_case(kind, n, window, rng)
        vals = np.arange(n, dtype=np.float32)
        tiles = tre.bank_tiles(1, n_out)
        out, tiles_seen = _bank_expand(starts, vals, n_out, tiles, head=1)
        np.testing.assert_array_equal(out, _oracle(starts, vals, n_out))
        assert len(tiles_seen) == tiles
        staged += [m for _, _, m in tiles_seen]
    if kind == "degenerate":  # every start past particle 17 is at n_in
        assert max(staged) == 1 + BANK_PHASE < n  # the head, one phase


@pytest.mark.parametrize("n_trials,n_in,tiles", [
    (1, tre.BANK_CAP + 1, None),  # over the cap: no block stages it
    (3, (1 << 16), 40),
    (1, 4096, 1),                 # 4096 rows in one tile: over 2048
    (1, 100, 101),                # more tiles than rows
])
def test_bank_form_raises_where_it_does_not_fit(n_trials, n_in, tiles):
    """A forced bank form that these inputs do not allow raises before any
    launch; nothing takes another form."""
    starts = torch.zeros((n_trials, n_in), dtype=torch.int32)
    vals = torch.zeros((n_trials, n_in, 1))
    with pytest.raises(ValueError, match="bank form"):
        tre._expand_cuda_batched(starts, vals, n_in, None, form=tre.BANK,
                                 tiles=tiles)


def test_n_out_bound_raises():
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        tre.expand_sorted_segments(starts, torch.zeros(4), n_out=1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        systematic_segment_starts(torch.zeros(4), 1 << 24, u0=0.5)
