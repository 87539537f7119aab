"""Kernel-against-plain tests on the card, at the shapes of chip_smoke.py.

Marked ``gpu``; each test skips (through the ``cuda`` fixture) when torch
sees no CUDA device. This file imports neither jax nor qinfer_tpu, so on
a GPU machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.ops import fused_update as b1
from qinfer_tpu_torch.ops import resample_expand as b2
from qinfer_tpu_torch.resamplers import systematic_segment_starts

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

N = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("outcome,t", [(0, 2.0), (0, 17.3), (1, 2.0),
                                       (1, 17.3)])
def test_fused_update_kernel_matches_plain(cuda, n, outcome, t):
    g = torch.Generator(device=cuda).manual_seed(n)
    omega = torch.rand(n, generator=g, device=cuda)
    lw = torch.log(torch.rand(n, generator=g, device=cuda))
    lw = lw - torch.logsumexp(lw, 0)
    scal = torch.tensor([float(outcome), t], device=cuda)
    tile = b1.two_outcome_tile(b1.precession_pr1)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, (omega,))
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, (omega,))
    torch.cuda.synchronize()
    # The JAX package's kernel-test tolerances.
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


def _log_weights(kind, n, rng):
    if kind == "random":
        w = rng.random(n) ** 3
    elif kind == "degenerate":
        w = np.zeros(n)
        w[17] = 1.0
    else:
        w = np.full(n, 1e-9)
        w[n // 2 + 1] = 1.0
    with np.errstate(divide="ignore"):
        return np.log(w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.ZOO, ids=lambda c: c[0])
def test_zoo_tile_kernel_matches_plain(cuda, case, n):
    tile, scal, lw, cols = chip_smoke.zoo_inputs(case, n, n, cuda)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


def test_wide_or_unknown_tile_raises_on_cuda(cuda):
    """More than 8 columns, or a pr1 with no functor, raises on CUDA
    instead of running the plain version."""
    model = qt.MultiCosModel(n_terms=9)
    locs = torch.rand((256, 9), device=cuda)
    lw = torch.full((256,), -float(np.log(256.0)), device=cuda)
    ep = {"ts": torch.rand((1, 9), device=cuda)}
    with pytest.raises(ValueError, match="at most 8"):
        model.fused_update(1, lw, locs, ep)
    tile = b1.two_outcome_tile(lambda scalars, off, x: x)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        b1.fused_bayes_update(tile, torch.ones(1, device=cuda), lw,
                              (locs[:, 0],))


@pytest.mark.parametrize("make", chip_smoke.CONFIGS,
                         ids=lambda m: m.__name__)
def test_config_path_runs_through_both_kernels(cuda, make):
    cfg = make()
    u = qt.SMCUpdater(cfg.model, 1 << 16, qt.UniformDistribution(cfg.prior),
                      zero_weight_policy="reset", device=cuda)
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    u.batch_update(cfg.outcomes, cfg.expparams)
    ok, est, sd = cfg.gate(u.est_mean().cpu().numpy(),
                           u.est_covariance_mtx().cpu().numpy())
    assert ok, (est, sd)
    assert b1.fused_bayes_update.launches - l1 == len(cfg.outcomes)
    assert b2.expand_sorted_segments.launches - l2 >= u.resample_count > 0


@pytest.mark.parametrize("n", [257, 16385, N])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("affine", [False, True])
def test_expand_kernel_equals_plain_bitwise(cuda, n, d, kind, affine):
    rng = np.random.default_rng(n + d)
    vals = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                           device=cuda)
    log_w = torch.as_tensor(_log_weights(kind, n, rng), device=cuda)
    starts = systematic_segment_starts(log_w, n, u0=0.37)
    scale, shift = (0.98, 0.02 * vals[0]) if affine else (None, None)
    launches = b2.expand_sorted_segments.launches
    out = b2.expand_sorted_segments(starts, vals, scale=scale, shift=shift)
    assert b2.expand_sorted_segments.launches == launches + 1
    ref = b2.expand_plain(starts, vals, n, b2._affine(scale, shift, d, cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_failed_launch_raises(cuda):
    """A launch the C entry point refuses (no columns) raises."""
    starts = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        b2._expand_cuda(starts, torch.empty((8, 0), device=cuda), 8, None)


def test_main_path_runs_through_both_kernels(cuda):
    rng = np.random.default_rng(0)
    ts = np.minimum((9 / 8) ** np.arange(100), 1e4).astype(np.float32)
    outcomes = (rng.random(100)
                >= np.cos(0.5 * 0.70710678 * ts) ** 2).astype(np.int32)
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), N,
                      qt.UniformDistribution([0, 1]),
                      zero_weight_policy="reset", device=cuda)
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    u.batch_update(outcomes, {"t": ts})
    assert abs(float(u.est_mean()[0]) - 0.70710678) < 0.05
    assert b1.fused_bayes_update.launches - l1 == 100
    assert b2.expand_sorted_segments.launches - l2 >= u.resample_count > 0
