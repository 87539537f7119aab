"""Inputs drawn from a run's ``--seed``: the same seed gives the same
inputs, whatever the program does with them.

Every stream has its own key, so a cell's records, banks, outcomes and
samples never share draws: ``derive(seed, "bank", i)`` seeds unit i's
initial bank, ``rng(seed, "record", i)`` draws its record.
"""

from __future__ import annotations

import zlib

import numpy as np


def _key(part):
    if isinstance(part, str):
        return zlib.crc32(part.encode())
    return int(part)


def sequence(seed, *keys):
    """The ``SeedSequence`` of stream ``keys`` under ``seed`` (any whole
    number ≥ 0, 64 bits and more)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"--seed must be a whole number ≥ 0, got {seed}")
    words = [seed & 0xFFFFFFFF, seed >> 32] + [_key(k) for k in keys]
    return np.random.SeedSequence(words)


def derive(seed, *keys):
    """A 62-bit integer seed (for a ``torch.Generator``) of stream ``keys``."""
    hi, lo = sequence(seed, *keys).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) >> 2


def rng(seed, *keys):
    """A NumPy generator of stream ``keys``."""
    return np.random.default_rng(sequence(seed, *keys))


def precession_record(n_exp, omega, t_cap, generator):
    """bench.py's record (frozen here): exp-sparse times t_k =
    min((9/8)^k, t_cap) and single-shot outcomes drawn at ``omega``,
    outcome 1 with probability 1 − cos²(ωt/2). Returns (ts f32, outcomes
    int32)."""
    ts = np.minimum((9 / 8) ** np.arange(n_exp), t_cap).astype(np.float32)
    p0 = np.cos(0.5 * omega * ts) ** 2
    outcomes = (generator.random(n_exp) >= p0).astype(np.int32)
    return ts, outcomes


def records(seed, n_units, n_exp, omega, t_cap):
    """The records of units 0 … n_units − 1: ((n_exp,) times, (n_units,
    n_exp) outcomes). The times are the same for every unit."""
    outs = []
    ts = None
    for i in range(n_units):
        ts, o = precession_record(n_exp, omega, t_cap, rng(seed, "record", i))
        outs.append(o)
    return ts, np.stack(outs)


def bloch_ball_truths(seed, n, pool):
    """(n, 4) coordinates in the normalised Pauli basis (I, X, Y, Z)/√2 of
    qubit states, x₀ = 1/√2, x₁…₃ = r/√2. The states are the same ``pool``
    for every seed, spread over the Bloch ball by its uniform measure (the
    full-rank Ginibre prior's): radii at the middles of ``pool`` shells of
    equal volume, directions drawn once. Each block of ``pool``
    consecutive units holds every state once, in an order drawn from the
    seed, so a window's work does not hang on which states a seed drew."""
    g = np.random.default_rng(np.random.SeedSequence(
        [_key("truth pool"), int(pool)]))
    v = g.standard_normal((pool, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = ((np.arange(pool) + 0.5) / pool) ** (1.0 / 3.0)
    states = np.empty((pool, 4))
    states[:, 0] = 1.0
    states[:, 1:] = v * r[:, None]
    order = rng(seed, "truth order")
    idx = np.concatenate([order.permutation(pool)
                          for _ in range(-(-n // pool))])[:n]
    return (states[idx] / np.sqrt(2.0)).astype(np.float32)


def sample(seed, population, k, *keys):
    """``k`` distinct members of ``range(population)`` (all when fewer),
    sorted, drawn from stream ``keys``."""
    k = min(k, population)
    return sorted(int(i) for i in rng(seed, "sample", *keys).choice(
        population, size=k, replace=False))
