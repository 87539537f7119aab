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
from qinfer_tpu_torch.interop import state_from_numpy, state_to_numpy
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
    """More columns than a functor takes (8 for MultiCos, which the kernel
    refuses; 16 for any tile) raises on CUDA instead of running the plain
    version; so does a pr1 with no functor handed to the kernel itself,
    which the wrapper sends to the column route, counted."""
    model = qt.MultiCosModel(n_terms=9)
    locs = torch.rand((256, 9), device=cuda)
    lw = torch.full((256,), -float(np.log(256.0)), device=cuda)
    ep = {"ts": torch.rand((1, 9), device=cuda)}
    with pytest.raises(RuntimeError, match="cudaError"):
        model.fused_update(1, lw, locs, ep)
    born = b1.two_outcome_tile(b1.make_born_pr1(17))
    wide = torch.rand((256, 17), device=cuda)
    with pytest.raises(ValueError, match="at most 16"):
        b1.fused_bayes_update(born, torch.rand(18, device=cuda), lw,
                              tuple(wide[:, d] for d in range(17)))
    tile = b1.two_outcome_tile(lambda scalars, off, x: x)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        b1._fused_update_cuda(tile, torch.ones((1, 1), device=cuda), lw[None],
                              (locs[None, :, 0],))
    counts = (b1.fused_bayes_update.launches,
              b1.fused_bayes_update.column_launches)
    b1.fused_bayes_update(tile, torch.ones(1, device=cuda), lw, (locs[:, 0],))
    assert (b1.fused_bayes_update.launches,
            b1.fused_bayes_update.column_launches) == (counts[0] + 1,
                                                       counts[1] + 1)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.TOMO, ids=lambda c: c[0])
def test_born_tile_kernel_matches_plain(cuda, case, n):
    tile, scal, lw, cols = chip_smoke.tomo_inputs(case, n, n, cuda)
    launches = b1.fused_bayes_update.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    assert b1.fused_bayes_update.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert abs(float(ln_k) - float(lse_p)) <= 1e-4
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)


@pytest.mark.parametrize("copy", ["all", "every_other"])
def test_strided_and_contiguous_columns_agree(cuda, copy):
    """The kernel reads each column in place with its own stride; copies
    of the same columns (stride 1), all of them or every other one, give
    the same bits."""
    tile, scal, lw, cols = chip_smoke.tomo_inputs(chip_smoke.TOMO[2], 4099,
                                                  5, cuda)
    assert cols[0].stride(0) == 16
    step = 1 if copy == "all" else 2
    mixed = tuple(c.contiguous() if j % step == 0 else c
                  for j, c in enumerate(cols))
    strided = b1.fused_bayes_update(tile, scal, lw, cols)
    copied = b1.fused_bayes_update(tile, scal, lw, mixed)
    torch.cuda.synchronize()
    for a, b in zip(strided, copied):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, N + 3])
@pytest.mark.parametrize("case", chip_smoke.SPAN_CASES,
                         ids=lambda c: f"s{c[0]}_k{c[1]}_{c[2]}")
def test_row_span_path_bit_equal_to_per_column(cuda, case, n):
    """On the same views of one (N, s) bank, the row-span path's
    log-weights, lse, lse2 and ESS equal the per-column path's bit for
    bit, for one bank and for T = 3 (each trial also bit-equal to a
    single-bank launch); the wrapper's own path stays within the kernel
    tolerances of the plain version."""
    s, k, view = case
    tile, scal, lw, cols = chip_smoke.span_inputs(s, k, view, n, 11, cuda)
    assert (b1._row_span(cols) is not None) == (s >= 8)
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    span, per_col = chip_smoke.both_paths(tile, scal[None], lw[None],
                                          tuple(c[None] for c in cols))
    torch.cuda.synchronize()
    for a, b in zip(span, per_col):
        assert torch.equal(a, b)
    torch.testing.assert_close(lw_k, lw_p - lse_p, atol=1e-4, rtol=0)
    assert float(ess_k) == pytest.approx(float(ess_p), rel=1e-3)
    tile, scal, lw, cols = chip_smoke.span_inputs(s, k, view, n, 12, cuda,
                                                  n_trials=3)
    span, per_col = chip_smoke.both_paths(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for a, b in zip(span, per_col):
        assert torch.equal(a, b)
    for i in range(3):
        single = b1._fused_update_cuda(tile, scal[i:i + 1], lw[i:i + 1],
                                       tuple(c[i:i + 1] for c in cols),
                                       row_span=True)
        assert torch.equal(single[0][0], span[0][i])
        assert torch.equal(single[1][0], span[1][i])


@pytest.mark.parametrize("d", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
@pytest.mark.parametrize("affine", [False, True])
def test_expand_forms_bit_equal(cuda, d, kind, affine):
    """B2 with n_out < n_in: the wrapper's form (the merge path up to D = 8,
    the span form at D ≥ 9) and every form forced (the merge path up to
    D = 8) are bit-equal to the plain version."""
    n_in, n_out = 16385, 10007
    rng = np.random.default_rng(d)
    vals = torch.as_tensor(rng.standard_normal((n_in, d)),
                           dtype=torch.float32, device=cuda)
    log_w = torch.as_tensor(_log_weights(kind, n_in, rng), device=cuda)
    starts = systematic_segment_starts(log_w, n_in, u0=0.37)
    aff = b2._affine(0.98, 0.02 * vals[0], d, cuda) if affine else None
    out = b2.expand_sorted_segments(starts, vals, n_out=n_out,
                                    scale=0.98 if affine else None,
                                    shift=0.02 * vals[0] if affine else None)
    forms = [b2._expand_cuda_batched(starts[None], vals[None], n_out,
                                     None if aff is None else aff[None],
                                     form=form)[0]
             for form in (b2.ROWS, b2.SPAN) + ((b2.MERGE,) if d <= 8 else ())]
    ref = b2.expand_plain(starts, vals, n_out, aff)
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in [out] + forms)


def _one_and_two_passes_equal(tile, scal, lw, cols):
    one, two = chip_smoke.both_forms(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("case", ("precession",) + chip_smoke.ZOO
                         + chip_smoke.TOMO,
                         ids=lambda c: c if isinstance(c, str) else c[0])
def test_one_launch_bit_equal_to_two_passes(cuda, case, n):
    """B1's per-column path: the one-launch form's lw − lse, lse, lse2, ESS
    and raw lw equal the two-pass form's bit for bit."""
    if case == "precession":
        omega, lw = chip_smoke._b1_inputs(n, n, cuda)
        tile = b1.two_outcome_tile(b1.precession_pr1)
        scal, cols = torch.tensor([1.0, 17.3], device=cuda), (omega,)
    elif case in chip_smoke.ZOO:
        tile, scal, lw, cols = chip_smoke.zoo_inputs(case, n, n, cuda)
    else:
        tile, scal, lw, cols = chip_smoke.tomo_inputs(case, n, n, cuda)
    _one_and_two_passes_equal(tile, scal[None], lw[None],
                              tuple(c[None] for c in cols))


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["precession", "multicos", "born4"])
def test_batched_one_launch_bit_equal_to_two_passes(cuda, name, shape):
    _one_and_two_passes_equal(*chip_smoke.batched_b1_inputs(name, *shape, 5,
                                                            cuda))


def test_too_large_cooperative_grid_raises(cuda):
    """512 trials of 2^14 particles need 4 blocks a trial at the least in
    one launch: more than the card holds at once, so the plan takes two
    passes and a forced one-launch form is refused."""
    tile, scal, lw, cols = chip_smoke.batched_b1_inputs("precession", 512,
                                                        1 << 14, 1, cuda)
    cap = b1._capacity(0, 0, 1, True, cuda.index)
    assert b1.grid_plan(512, 1 << 14, cap).form == b1.TWO_PASS
    with pytest.raises(RuntimeError, match="cudaError"):
        b1._fused_update_cuda(tile, scal, lw, cols, form=b1.ONE_LAUNCH)
    b1.fused_bayes_update_batched(tile, scal, lw, cols)  # the card recovers
    torch.cuda.synchronize()


@pytest.mark.parametrize("model_case", [0, 2], ids=["qubit", "binomial_2q"])
def test_design_on_a_cuda_bank(cuda, model_case):
    """bayes_risk and expected_information_gain on a CUDA bank: the
    outcomes and Q follow the bank to the card, and the result agrees with
    the same state on the CPU."""
    _, model, prior, _, _ = chip_smoke.TOMO[model_case]
    u = qt.SMCUpdater(model, 1 << 14, prior, zero_weight_policy="reset",
                      device=cuda)
    if isinstance(model, qt.BinomialModel):
        rng = np.random.default_rng(0)
        cand = {"meas": np.stack([chip_smoke.product_projector_2q(rng)
                                  for _ in range(3)]),
                "n_meas": np.full(3, 50, np.int32)}
    else:
        cand = {"meas": chip_smoke.EFFECTS_1Q}
    host = qt.SMCUpdater(model, 1 << 14, prior, zero_weight_policy="reset",
                         device="cpu")
    host.state = state_from_numpy(state_to_numpy(u.state))
    for name in ("bayes_risk", "expected_information_gain"):
        on_card = getattr(u, name)(cand)
        assert on_card.device.type == "cuda" and on_card.shape == (3,)
        torch.testing.assert_close(on_card.cpu(), getattr(host, name)(cand),
                                   rtol=1e-4, atol=1e-6)


def test_tomography_paths_run_through_both_kernels(cuda):
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.config5_window(chip_smoke.config5_updater(1 << 16, 1,
                                                             cuda), 0)
    ok, err, spread = chip_smoke.config5_gate(w)
    assert ok, (err, spread)
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_STEPS_1Q
    assert (b2.expand_sorted_segments.launches - l2
            >= w["updater"].resample_count > 0)
    l1 = b1.fused_bayes_update.launches
    w = chip_smoke.tomography_2q_window(
        chip_smoke.tomography_2q_updater(1 << 16, 1, cuda))
    ok, overlap = chip_smoke.tomography_2q_gate(w)
    assert ok, overlap
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_SETTINGS_2Q


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
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16])
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


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["precession", "multicos", "born4"])
def test_batched_fused_update_kernel(cuda, name, shape):
    """One launch for T banks: within the kernel tolerances of its plain
    version, and each trial bit-equal to a single-bank launch."""
    tile, scal, lw, cols = chip_smoke.batched_b1_inputs(name, *shape, 3,
                                                        cuda)
    launches = b1.fused_bayes_update_batched.launches
    lw_k, ln_k, ess_k = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    assert b1.fused_bayes_update_batched.launches == launches + 1
    lw_p, lse_p, _, ess_p = b1.fused_update_plain_batched(tile, scal, lw,
                                                          cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(lw_k, lw_p - lse_p[:, None], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(ln_k, lse_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(ess_k, ess_p, rtol=1e-3, atol=0)
    for i in range(shape[0]):
        lw_1, ln_1, _ = b1.fused_bayes_update(tile, scal[i], lw[i],
                                              tuple(c[i] for c in cols))
        assert torch.equal(lw_1, lw_k[i]) and torch.equal(ln_1, ln_k[i])


@pytest.mark.parametrize("shape", chip_smoke.B2_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_batched_expand_kernel_bit_equal(cuda, shape):
    n_trials, n, d = shape
    starts, vals, mu = chip_smoke.batched_b2_inputs(n_trials, n, d, 1, cuda)
    launches = b2.expand_sorted_segments_batched.launches
    out = b2.expand_sorted_segments_batched(starts, vals, scale=0.98,
                                            shift=0.02 * mu)
    assert b2.expand_sorted_segments_batched.launches == launches + 1
    ref = b2.expand_plain_batched(
        starts, vals, n, b2._affine_batched(0.98, 0.02 * mu, n_trials, d,
                                            cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for i in range(n_trials):
        assert torch.equal(out[i], b2.expand_sorted_segments(
            starts[i], vals[i], scale=0.98, shift=0.02 * mu[i]))


def test_ensemble_runs_through_the_batched_kernels(cuda):
    b1_single = b1.fused_bayes_update.launches
    l1 = b1.fused_bayes_update_batched.launches
    l2 = b2.expand_sorted_segments_batched.launches
    seconds, perf, steps_resampled = chip_smoke.ensemble_run(32, 2048, 30, 7,
                                                             cuda)
    assert float(np.median(perf["loss"][:, -1])) < 1e-3
    assert b1.fused_bayes_update_batched.launches - l1 == 30 + 2  # warm-up
    assert b1.fused_bayes_update.launches == b1_single
    assert (b2.expand_sorted_segments_batched.launches - l2
            >= steps_resampled > 0)
    assert seconds > 0


@pytest.mark.parametrize("path", chip_smoke.PGH_PATHS, ids=lambda p: p[0])
def test_pgh_paths_run_through_both_kernels(cuda, path):
    _, model, truth, slack = path
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.pgh_window(model, truth, 1, cuda, n=1 << 16)
    assert w["finite"] and abs(w["est"] - truth) < 6 * w["sd"] + slack
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_PGH_STEPS
    assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


def test_entry_points_default_to_the_card(cuda):
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 1024,
                      qt.UniformDistribution([0, 1]))
    assert u.particle_locations.device.type == "cuda"
    perf = qt.perf_test_multiple(2, qt.SimplePrecessionModel(), 256,
                                 qt.UniformDistribution([0, 1]), 3, qt.PGH)
    assert perf.shape == (2, 3)


def test_accelerated_precession_update_bit_equal_to_simple(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    locs = torch.rand((N, 1), generator=g, device=cuda)
    lw = torch.log(torch.rand(N, generator=g, device=cuda))
    lw = lw - torch.logsumexp(lw, 0)
    ep = {"t": torch.tensor([17.3], device=cuda)}
    launches = b1.fused_bayes_update.launches
    out_a = qt.AcceleratedPrecessionModel().fused_update(1, lw, locs, ep)
    out_s = qt.SimplePrecessionModel().fused_update(1, lw, locs, ep)
    assert b1.fused_bayes_update.launches == launches + 2
    torch.cuda.synchronize()
    assert all(torch.equal(a, s) for a, s in zip(out_a, out_s))


def test_credible_set_and_histogram_against_the_host(cuda):
    """The device's credible cut against an f64 NumPy recomputation (±1),
    and the device histogram against np.histogram on the same weights."""
    cfg = chip_smoke.config4_multicos2()
    _, _, _, _, u = chip_smoke._config_window(cfg, 4, cuda, n=1 << 16)
    region = u.est_credible_region(0.95)
    w = u.particle_weights.cpu().numpy()
    assert region.device.type == "cuda"
    assert abs(region.shape[0] - chip_smoke.host_credible_size(w)) <= 1
    xs, hist = u.posterior_marginal(1)
    x = u.particle_locations[:, 1].cpu().numpy()
    ref, edges = np.histogram(x, bins=100, range=(float(x.min()),
                                                  float(x.max())),
                              weights=w, density=True)
    assert hist.device.type == "cuda"
    np.testing.assert_allclose(hist.cpu().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * ref.max())
    np.testing.assert_array_equal(xs.cpu().numpy(),
                                  0.5 * (edges[1:] + edges[:-1]))
    s = chip_smoke.posterior_summaries(u, cfg.truth, cuda)
    assert chip_smoke.summaries_gate(s), s


def test_engine_api_paths_run_through_both_kernels(cuda):
    for window, gate, n_b1 in (
            (chip_smoke.bcrb_window, chip_smoke.bcrb_gate,
             lambda w: chip_smoke.N_EXP),
            (chip_smoke.track_rsd_window, chip_smoke.track_rsd_gate,
             lambda w: chip_smoke.N_EXP),
            (chip_smoke.mixed_ale_window, chip_smoke.mixed_ale_gate,
             lambda w: chip_smoke.N_EXP - w["approx_updates"])):
        l1 = b1.fused_bayes_update.launches
        l2 = b2.expand_sorted_segments.launches
        w = window(1 << 16, 1, cuda)
        assert gate(w), {k: v for k, v in w.items() if k != "updater"}
        assert b1.fused_bayes_update.launches - l1 == n_b1(w)
        assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


def test_new_updaters_default_to_the_card(cuda):
    prior = qt.UniformDistribution([0, 1])
    u = qt.SMCUpdaterBCRB(qt.SimplePrecessionModel(), 1024, prior)
    assert u.particle_locations.device.type == "cuda"
    assert u.current_bim.device.type == "cuda"
    m = qt.MixedApproximateSMCUpdater(
        qt.SimplePrecessionModel(),
        qt.ALEApproximateModel(simulator=qt.SimplePrecessionModel()), 1024,
        prior)
    assert m.particle_locations.device.type == "cuda"
    m.update(1, {"t": np.array([1.0], np.float32)})
    assert m.model is m.approximate_model


# -- the rest of the model zoo (vector outcomes, random walks, Poisson) ----------

def _zoo_likelihood_cases():
    rng = np.random.default_rng(0)
    die3 = rng.dirichlet(np.ones(3), 4096).astype(np.float32)
    walk = np.stack([rng.random(4096), rng.uniform(0, 0.05, 4096)],
                    1).astype(np.float32)
    beta = rng.uniform(0.0, 5.0, 4096)
    pois = np.stack([rng.random(4096), beta + rng.uniform(0, 20, 4096), beta],
                    1).astype(np.float32)
    omega = rng.random((4096, 1)).astype(np.float32)
    return [
        (qt.NDieModel(n=3), die3, {"exp_num": np.zeros(2, np.int32)},
         torch.arange(3)),
        (qt.MultinomialModel(qt.NDieModel(n=3)), die3,
         {"exp_num": np.zeros(2, np.int32), "n_meas": np.array([20, 20])},
         qt.MultinomialDomain(20, 3).values),
        (qt.RandomWalkModel(qt.BinomialModel(qt.SimplePrecessionModel()),
                            qt.NormalDistribution(0.0, 1e-4)), omega,
         {"t": np.array([np.pi / 2], np.float32), "n_meas": np.array([40])},
         torch.arange(41)),
        (qt.GaussianRandomWalkModel(qt.SimplePrecessionModel()), walk,
         {"t": np.array([1.0, 9.0], np.float32)}, torch.arange(2)),
        (qt.MLEModel(qt.CoinModel(), likelihood_power=4.0), omega,
         {"dummy": np.zeros(1, np.float32)}, torch.arange(2)),
        (qt.ReferencedPoissonModel(qt.SimplePrecessionModel(), max_rate=25.0),
         pois, {"t": np.array([1.0, 2.0, 3.0], np.float32),
                "mode": np.array([0, 1, 2])}, torch.arange(60)),
    ]


@pytest.mark.parametrize("i", range(6), ids=["ndie", "multinomial", "walk",
                                             "gaussian_walk", "mle",
                                             "poisson"])
def test_zoo_model_likelihood_on_cuda_matches_cpu(cuda, i):
    model, params, ep, outcomes = _zoo_likelihood_cases()[i]
    ep_dev = {k: torch.as_tensor(v, device=cuda) for k, v in ep.items()}
    got = model.log_likelihood(outcomes.to(cuda),
                               torch.from_numpy(params).to(cuda), ep_dev)
    ref = model.log_likelihood(outcomes, torch.from_numpy(params), ep)
    assert got.device.type == "cuda"
    # Likelihoods, as test_torch_models.py holds the two packages: cos and
    # lgamma round differently on the card, and 1 − cos² near ω = 0
    # cancels in f32, so Pr(1) there is good to ~2⁻²³ absolute and a
    # 40-shot likelihood to ~40·2⁻²³ ≈ 5e-6.
    got, ref = got.cpu().numpy(), ref.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(np.exp(got), np.exp(ref), rtol=1e-3,
                               atol=1e-5)
    sims = model.simulate_experiment(
        torch.Generator(device=cuda).manual_seed(0),
        torch.from_numpy(params[:64]).to(cuda), ep_dev, repeat=3)
    assert sims.device.type == "cuda" and sims.dtype == torch.int32


def _assert_moments(x, mean, var):
    x = x.double()
    n = x.shape[0]
    assert torch.all((x.mean(0) - mean).abs() < 5 * (var / n).sqrt() + 1e-9)
    assert torch.all((x.var(0) / var - 1.0).abs() < 0.05)


def test_cuda_generator_draws_by_moments(cuda):
    """sample_multinomial (torch.binomial), torch.poisson and
    torch._standard_gamma on a CUDA generator: on the card, reproducible
    from the seed, with the right first two moments at 2^20 draws."""
    n = 1 << 20

    def gen(seed=0):
        return torch.Generator(device=cuda).manual_seed(seed)

    p = torch.tensor([0.6, 0.3, 0.1], device=cuda)
    counts = qt.utils.sample_multinomial(gen(), torch.tensor(20.0), p, (n,))
    assert counts.device.type == "cuda"
    assert bool((counts.sum(1) == 20).all())
    torch.testing.assert_close(
        counts, qt.utils.sample_multinomial(gen(), torch.tensor(20.0), p,
                                            (n,)), rtol=0, atol=0)
    _assert_moments(counts, 20 * p.double(), 20 * p.double() * (1 - p.double()))
    lam = torch.full((n, 2), 7.5, device=cuda)
    lam[:, 1] = 120.0
    draws = qt.utils.poisson(lam, gen(1))
    assert draws.device.type == "cuda"
    _assert_moments(draws, lam[0].double(), lam[0].double())
    alpha = torch.full((n, 2), 0.7, device=cuda)
    alpha[:, 1] = 5.0
    g = qt.utils.standard_gamma(alpha, gen(2))
    assert g.device.type == "cuda" and bool((g > 0).all())
    _assert_moments(g, alpha[0].double(), alpha[0].double())
    beta = qt.BetaDistribution(2.0, 5.0).sample(gen(3), n)
    _assert_moments(beta, torch.tensor(2 / 7, dtype=torch.float64,
                                       device=cuda),
                    torch.tensor(10 / 392, dtype=torch.float64, device=cuda))


def test_samplers_in_a_row_are_independent(cuda):
    """Two binomial (and two Poisson) calls in a row on one CUDA generator
    draw independently: |r| < 5/√n at 2^20."""
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(4)
    count = torch.full((n,), 20.0, device=cuda)
    for draw in (lambda: qt.utils.binomial(count, count * 0.02, g),
                 lambda: qt.utils.poisson(count * 0.4, g)):
        a, b = draw(), draw()
        r = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        assert abs(r) < 5 / np.sqrt(n), r


def test_every_distribution_samples_on_cuda(cuda):
    dists = [
        qt.UniformDistribution([[0, 1], [2, 3]]), qt.MVUniformDistribution(4),
        qt.DiscreteUniformDistribution(3), qt.ConstantDistribution([1.0]),
        qt.NormalDistribution(0.0, 2.0),
        qt.NormalDistribution(0.0, 1.0, trunc=(2.0, 6.0)),
        qt.MultivariateNormalDistribution([0, 1], [[1, 0.5], [0.5, 2]]),
        qt.SlantedNormalDistribution([[0, 1]]), qt.LogNormalDistribution(),
        qt.BetaDistribution(2.0, 5.0), qt.BetaBinomialDistribution(12, 2, 3),
        qt.GammaDistribution(3.0, 2.0),
        qt.ProductDistribution(qt.NormalDistribution(),
                               qt.UniformDistribution([0, 1])),
        qt.MixtureDistribution([1, 3], [qt.NormalDistribution(-1, 0.5),
                                        qt.NormalDistribution(2, 0.1)]),
        qt.ConstrainedSumDistribution(qt.UniformDistribution([[0, 1]] * 3)),
        qt.PostselectedDistribution(qt.NormalDistribution(0.5, 0.25),
                                    qt.SimplePrecessionModel()),
        qt.InterpolatedUnivariateDistribution(lambda x: np.exp(-x * x / 2),
                                              2.0, 500),
    ]
    g = torch.Generator(device=cuda).manual_seed(0)
    for d in dists:
        s = d.sample(g, 1 << 16)
        assert s.device.type == "cuda" and s.shape == (1 << 16, d.n_rvs)
        assert bool(torch.isfinite(s).all()), type(d).__name__


@pytest.mark.parametrize("path", chip_smoke.ZOO_PATHS, ids=lambda p: p[0])
def test_model_zoo_paths_run_unfused_through_b2(cuda, path):
    """Each model-zoo path at N = 2^16: its gate, no B1 launch (no tile),
    B2 at least once per resample."""
    name, make, window, gate = path
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = window(make(1 << 16, 1, cuda))
    ok, values = gate(w)
    assert ok, (name, values)
    assert w["updater"].particle_locations.device.type == "cuda"
    assert b1.fused_bayes_update.launches == l1
    assert b2.expand_sorted_segments.launches - l2 >= w["resamples"] > 0


@pytest.mark.parametrize("k_shards", chip_smoke.SHARD_KS)
@pytest.mark.parametrize("d", chip_smoke.SHARD_DS)
@pytest.mark.parametrize("kind", ["random", "degenerate", "single_heavy"])
def test_expand_kernel_on_shard_windows(cuda, k_shards, d, kind):
    """B2 on each rank's window of a 2^20 bank over K ranks (n_in = 2^20,
    n_out = 2^20 / K, shifted starts with a run of leading zeros) bit-equal
    to its plain version; the windows together equal one bank's expand."""
    rng = np.random.default_rng(k_shards + d)
    log_w = torch.as_tensor(_log_weights(kind, N, rng), device=cuda)
    vals = torch.as_tensor(rng.standard_normal((N, d)), dtype=torch.float32,
                           device=cuda)
    n_local = N // k_shards
    starts, windows = chip_smoke.shard_windows(log_w, k_shards, 0.61)
    torch.testing.assert_close(starts, systematic_segment_starts(
        log_w, N, u0=0.61), rtol=0, atol=0)
    launches = b2.expand_sorted_segments.launches
    outs = [b2.expand_sorted_segments(w, vals, n_out=n_local, scale=0.98,
                                      shift=0.5) for w in windows]
    assert b2.expand_sorted_segments.launches == launches + k_shards
    aff = b2._affine(0.98, 0.5, d, cuda)
    for w, out in zip(windows, outs):
        assert torch.equal(out, b2.expand_plain(w, vals, n_local, aff))
    assert torch.equal(torch.cat(outs), b2.systematic_expand(
        log_w, vals, scale=0.98, shift=0.5, u0=0.61))


@pytest.mark.parametrize("name", ["precession", "born4"])
def test_fused_update_stats_merge_over_shards(cuda, name):
    """B1's raw statistics on 4 slices, merged as the sharded step merges
    them, against the one-bank launch (B1_TOL), the raw lw bit-equal."""
    if name == "precession":
        omega, lw = chip_smoke._b1_inputs(N, 3, cuda)
        tile, scal, cols = (b1.two_outcome_tile(b1.precession_pr1),
                            torch.tensor([0.0, 9.1], device=cuda), (omega,))
    else:
        tile, scal, lw, cols = chip_smoke.tomo_inputs(chip_smoke.TOMO[0], N,
                                                      3, cuda)
    lw_1, ln_1, ess_1 = b1.fused_bayes_update(tile, scal, lw, cols)
    blocks = [slice(k * N // 4, (k + 1) * N // 4) for k in range(4)]
    parts = [b1.fused_bayes_update(tile, scal, lw[b], tuple(c[b] for c in cols),
                                   return_stats=True) for b in blocks]
    log_norm = chip_smoke.merge_lse(torch.stack([p[1] for p in parts]))
    lse2 = chip_smoke.merge_lse(torch.stack([p[2] for p in parts]))
    raw = torch.cat([p[0] for p in parts])
    assert torch.equal(raw, b1.fused_bayes_update(tile, scal, lw, cols,
                                                  return_stats=True)[0])
    torch.testing.assert_close(raw - log_norm, lw_1, atol=1e-4, rtol=0)
    assert abs(float(log_norm) - float(ln_1)) <= 1e-4
    assert float(torch.exp(2 * log_norm - lse2)) == pytest.approx(
        float(ess_1), rel=1e-3)


@pytest.fixture
def nccl_world_one(cuda):
    """An NCCL process group of one rank (file store), destroyed after the
    test; yields the particle mesh."""
    with chip_smoke.nccl_world_one(cuda) as mesh:
        yield mesh


@pytest.mark.parametrize("migration", ["all_gather", "ring"])
def test_sharded_step_on_nccl_world_one(cuda, nccl_world_one, migration):
    """The flagship record through the sharded step at 2^20 on one rank:
    the gate, B1 once per update (raw statistics), B2 at least once per
    resample on the all-gather and never on the ring."""
    l1 = b1.fused_bayes_update.launches
    l2 = b2.expand_sorted_segments.launches
    w = chip_smoke.sharded_flagship_window(nccl_world_one, migration, 5, 0,
                                           cuda)
    assert w["ok"], w["gate"]
    assert b1.fused_bayes_update.launches - l1 == chip_smoke.N_EXP
    b2_launches = b2.expand_sorted_segments.launches - l2
    if migration == "ring":
        assert b2_launches == 0 and w["resamples"] > 0
    else:
        assert b2_launches >= w["resamples"] > 0


@pytest.mark.parametrize("kind", ["pgh", "eig"])
def test_sharded_episodes_on_nccl_world_one(cuda, nccl_world_one, kind):
    w = chip_smoke.sharded_episode_window(nccl_world_one, kind, 1, cuda)
    assert w["ok"], w["gate"]


def test_checkpoint_resumes_a_cuda_updater_bit_for_bit(cuda, tmp_path):
    from qinfer_tpu_torch import checkpointing

    ts, outcomes = chip_smoke.experiment_record(chip_smoke.N_EXP, 0)

    def updater(seed):
        return qt.SMCUpdater(qt.SimplePrecessionModel(), 1 << 16,
                             qt.UniformDistribution([0, 1]),
                             zero_weight_policy="reset", seed=seed,
                             device=cuda)

    a = updater(1)
    a.batch_update(outcomes[:50], {"t": ts[:50]})
    checkpointing.save_npz(tmp_path / "ckpt.npz", a)
    at_save = a.resample_count
    b = checkpointing.load_npz(tmp_path / "ckpt.npz", updater(2))
    for u in (a, b):
        u.batch_update(outcomes[50:], {"t": ts[50:]})
    assert a.resample_count > at_save
    for name in ("particle_locations", "particle_log_weights", "n_resamples"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))


# -- B1 on a model's own pr1 (chip_smoke's user model) ----------------------------

@pytest.mark.parametrize("n", [1000, N + 3, N])
@pytest.mark.parametrize("binomial", [False, True], ids=["two_outcome",
                                                         "binomial"])
def test_user_functor_matches_plain(cuda, binomial, n):
    """The user library's tile against its plain version, and the column
    route (the torch-only twin) against the user tile, within B1_TOL."""
    tile, scal, lw, cols = chip_smoke.user_inputs(binomial, n, n, cuda)
    counts = (b1.fused_bayes_update.user_launches,
              b1.fused_bayes_update.column_launches)
    lw_k, ln_k, ess_k = b1.fused_bayes_update(tile, scal, lw, cols)
    twin = type(tile)(chip_smoke.LOST_VISIBILITY_TORCH)
    lw_c, ln_c, ess_c = b1.fused_bayes_update(twin, scal, lw, cols)
    assert (b1.fused_bayes_update.user_launches,
            b1.fused_bayes_update.column_launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    lw_p, lse_p, _, ess_p = b1.fused_update_plain(tile, scal, lw, cols)
    torch.cuda.synchronize()
    for lw_x, ln_x, ess_x, lw_y, ln_y, ess_y in (
            (lw_k, ln_k, ess_k, lw_p - lse_p, lse_p, ess_p),
            (lw_c, ln_c, ess_c, lw_k, ln_k, ess_k)):
        torch.testing.assert_close(lw_x, lw_y, atol=1e-4, rtol=0)
        assert abs(float(ln_x) - float(ln_y)) <= 1e-4
        assert float(ess_x) == pytest.approx(float(ess_y), rel=1e-3)


@pytest.mark.parametrize("shape", chip_smoke.B1_BATCH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_user_functor_trial_grid_bit_equal_to_single_banks(cuda, shape):
    tile, scal, lw, cols = chip_smoke.user_batched_inputs(*shape, 3, cuda)
    lw_k, ln_k, _ = b1.fused_bayes_update_batched(tile, scal, lw, cols)
    for i in range(shape[0]):
        lw_1, ln_1, _ = b1.fused_bayes_update(tile, scal[i], lw[i],
                                              tuple(c[i] for c in cols))
        assert torch.equal(lw_1, lw_k[i]) and torch.equal(ln_1, ln_k[i])


def test_malformed_user_source_raises_with_nvcc_message(cuda):
    """A user functor that does not compile raises with nvcc's message at
    its first launch; nothing takes the column route or the plain
    version."""
    bad = b1.cuda_pr1(chip_smoke.lost_visibility_pr1,
                      "struct UserPr1 { this is not C++; };")
    tile, scal, lw, cols = chip_smoke.user_inputs(False, 1000, 1, cuda)
    counts = (b1.fused_bayes_update.launches,
              b1.fused_bayes_update.column_launches)
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        b1.fused_bayes_update(type(tile)(bad), scal, lw, cols)
    assert "error" in str(err.value)
    assert (b1.fused_bayes_update.launches,
            b1.fused_bayes_update.column_launches) == counts
