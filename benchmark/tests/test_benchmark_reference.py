"""The plain references at a tiny size, against direct computations; and
that they load nothing of the system under test."""

import math
import subprocess
import sys

import numpy as np
import torch

import _paths
from harness import inputs, registry

REG = registry.Registry()
PRECESSION = REG.module("reference", "precession")
QUBIT = REG.module("reference", "qubit")


def _brute(ts, outcomes, lo, hi, n=400001):
    x = torch.linspace(lo, hi, n, dtype=torch.float64)
    ll = torch.zeros_like(x)
    for t, o in zip(ts, outcomes):
        p0 = torch.cos(0.5 * x * float(t)) ** 2
        ll += torch.log(torch.clamp(p0 if o == 0 else 1 - p0, min=1e-300))
    p = torch.softmax(ll, 0)
    mean = float(p @ x)
    sd = float(torch.sqrt(p @ (x - mean) ** 2))
    log_z = float(torch.logsumexp(ll, 0)) + math.log((hi - lo) / (n - 1)) \
        - math.log(hi - lo)
    return mean, sd, log_z


def test_precession_posterior_against_a_fine_grid():
    ts, outs = inputs.records(5, 3, 30, 0.70710678, 1e4)
    for o in outs:
        got = PRECESSION.posterior(ts, o)
        mean, sd, log_z = _brute(ts, o, 0.0, 1.0)
        assert abs(got["mean"] - mean) < 0.01 * sd
        assert abs(got["sd"] / sd - 1) < 0.01
        assert abs(got["log_evidence"] - log_z) < 1e-3


def test_precession_posterior_of_no_data_is_the_prior():
    got = PRECESSION.posterior(np.zeros(0), np.zeros(0), 0.0, 1.0)
    assert abs(got["mean"] - 0.5) < 1e-12
    assert abs(got["sd"] - 1 / math.sqrt(12)) < 1e-9
    assert abs(got["log_evidence"]) < 1e-12


def test_precession_bfloat16_control_is_far_off():
    ts, outs = inputs.records(6, 1, 100, 0.70710678, 1e4)
    exact = PRECESSION.posterior(ts, outs[0])
    ctl = PRECESSION.posterior(ts, outs[0], dtype=torch.bfloat16)
    assert abs(ctl["mean"] - exact["mean"]) / exact["sd"] > 100


def test_qubit_update_and_information_gain():
    g = torch.Generator().manual_seed(0)
    n = 4096
    r = torch.randn(n, 3, generator=g, dtype=torch.float64)
    r = r / r.norm(dim=1, keepdim=True) * torch.rand(n, 1, generator=g,
                                                      dtype=torch.float64)
    locs = torch.cat([torch.ones(n, 1, dtype=torch.float64), r], 1) \
        / math.sqrt(2)
    log_w = torch.log(torch.rand(n, generator=g, dtype=torch.float64))
    log_w = log_w - torch.logsumexp(log_w, 0)
    effects = torch.tensor([[1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1]],
                           dtype=torch.float64) / math.sqrt(2)
    w0 = torch.exp(log_w)
    for k in range(3):
        p1 = (1 + r[:, k]) / 2  # Tr(ρ Π₊) on the k-th Pauli axis
        for o in (0, 1):
            lik = p1 if o else 1 - p1
            w, ln = QUBIT.update(locs, log_w, effects[k], o)
            assert torch.allclose(w, w0 * lik / (w0 @ lik), atol=1e-15)
            assert abs(float(ln) - math.log(float(w0 @ lik))) < 1e-12
    ig = QUBIT.information_gain(locs, log_w, effects)
    for k in range(3):
        p1 = (1 + r[:, k]) / 2
        m = float(w0 @ p1)

        def h(p):
            p = np.clip(p, 1e-300, 1 - 1e-16)
            return -(p * np.log(p) + (1 - p) * np.log(1 - p))

        want = h(m) - float(w0 @ torch.as_tensor(h(p1.numpy())))
        assert abs(float(ig[k]) - want) < 1e-9


def test_qubit_validity():
    s = 1 / math.sqrt(2)
    locs = torch.tensor([[s, s, 0, 0],  # pure: on the sphere
                         [s, 0.5 * s, 0, 0],  # mixed
                         [s, 1.01 * s, 0, 0],  # outside the ball
                         [s + 1e-3, 0, 0, 0]])  # trace off
    assert QUBIT.invalid(locs, 1e-5, 1e-4) == 2


def test_references_load_nothing_of_the_system():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from harness import registry\n"
        "reg = registry.Registry()\n"
        "reg.module('reference', 'precession'); reg.module('reference', 'qubit')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qinfer_tpu_torch', 'qinfer_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(bad)\n" % _paths.FOLDER)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
