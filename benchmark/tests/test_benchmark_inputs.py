"""The drivers' inputs are fixed by the seed, and every seed gives the
same sizes."""

import numpy as np
import pytest

import _paths  # noqa: F401
from harness import inputs

BIG = 2 ** 31 + 987654321  # larger than 32 signed bits hold


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_records_fixed_by_seed(seed):
    a_ts, a = inputs.records(seed, 16, 100, 0.70710678, 1e4)
    b_ts, b = inputs.records(seed, 16, 100, 0.70710678, 1e4)
    assert np.array_equal(a_ts, b_ts) and np.array_equal(a, b)
    assert a.shape == (16, 100) and a.dtype == np.int32
    # each unit its own record, the times of every record the same
    assert len({r.tobytes() for r in a}) == 16
    assert a_ts[0] == 1.0 and a_ts.max() == np.float32(1e4)


def test_records_differ_between_seeds_in_draws_not_sizes():
    ts1, a = inputs.records(BIG, 8, 100, 0.70710678, 1e4)
    ts2, b = inputs.records(BIG + 1, 8, 100, 0.70710678, 1e4)
    assert np.array_equal(ts1, ts2) and a.shape == b.shape
    assert not np.array_equal(a, b)


def test_record_is_the_bench_record():
    """The frozen copy draws the repository bench's record: outcome 1 with
    probability 1 − cos²(ωt/2) at t = min((9/8)^k, 1e4)."""
    g1 = np.random.default_rng(3)
    ts, o = inputs.precession_record(100, 0.70710678, 1e4, g1)
    g2 = np.random.default_rng(3)
    want_ts = np.minimum((9 / 8) ** np.arange(100), 1e4).astype(np.float32)
    want = (g2.random(100) >= np.cos(0.5 * 0.70710678 * want_ts) ** 2)
    assert np.array_equal(ts, want_ts)
    assert np.array_equal(o, want.astype(np.int32))


def test_truths_fixed_by_seed_and_physical():
    a = inputs.bloch_ball_truths(BIG, 500, 16)
    assert np.array_equal(a, inputs.bloch_ball_truths(BIG, 500, 16))
    b = inputs.bloch_ball_truths(BIG + 1, 500, 16)
    assert not np.array_equal(a, b)
    # every seed runs the same states, each once in a block of the pool
    for lo in range(0, 496, 16):
        assert np.array_equal(np.unique(a[lo:lo + 16], axis=0),
                              np.unique(b[lo:lo + 16], axis=0))
        assert len(np.unique(a[lo:lo + 16], axis=0)) == 16
    assert np.allclose(a[:, 0], 1 / np.sqrt(2))
    r = np.linalg.norm(a[:, 1:], axis=1) * np.sqrt(2)
    assert r.max() <= 1.0 + 1e-6
    # uniform in the ball: the radius's cube is uniform, mean 1/2
    assert abs(np.mean(r ** 3) - 0.5) < 0.05


def test_derive_and_sample():
    assert inputs.derive(BIG, "bank", 3) == inputs.derive(BIG, "bank", 3)
    assert inputs.derive(BIG, "bank", 3) != inputs.derive(BIG, "bank", 4)
    assert inputs.derive(BIG, "bank", 3) != inputs.derive(BIG + 1, "bank", 3)
    assert 0 <= inputs.derive(2 ** 70, "x") < 2 ** 62
    s = inputs.sample(BIG, 100, 8, "units")
    assert s == inputs.sample(BIG, 100, 8, "units")
    assert len(set(s)) == 8 and all(0 <= i < 100 for i in s)
    assert inputs.sample(BIG, 3, 8, "units") == [0, 1, 2]
    with pytest.raises(ValueError):
        inputs.derive(-1, "x")
