"""Port parity for the trial ensembles (CPU): the batched forms of B1 and
B2, the simulator, the batched SMC step and ``perf_test`` /
``perf_test_multiple``.

- Batched B1 (plain version) against ``jax.vmap`` of the JAX
  ``fused_bayes_update`` in interpret mode (its ``custom_vmap`` rule takes
  the vectorized XLA equivalent at these sizes) and against JAX
  single-bank calls per trial; tolerance: log-weights atol 1e-5 plus the
  likelihood's conditioning term above max − 20 (``test_torch_fused_tiles``
  explains the term: the two frameworks round cos, exp and log apart by an
  ulp), the tail on the weight scale, log_norm atol 1e-5, ESS rtol 1e-4.
- Batched B2 (plain version) bit-equal to ``jax.vmap`` of the JAX expand
  kernel on the same starts; with the affine within one ulp (XLA on the
  CPU contracts x·a + b into an FMA) and exactly numpy's rounding.
- The batched step against T single-bank steps with injected u0 and smear
  noise; the simulator against the JAX simulator by moments (5σ); the
  harness's result layout, learning, the JAX package's median final loss
  (the factor is measured by ``python tests/test_torch_ensemble.py``), the
  timing modes and the progress bar.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_tiles import ZOO, IDS, _bank, _conditioning, _jax_tile

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.ops import fused_update as jfu
from qinfer_tpu.ops.resample_expand import expand_sorted_segments as j_expand
from qinfer_tpu_torch.entry import entry
from qinfer_tpu_torch.interop import from_reference, state_from_numpy
from qinfer_tpu_torch.ops import fused_update as tfu
from qinfer_tpu_torch.ops import resample_expand as tre
from qinfer_tpu_torch.resamplers import (
    systematic_segment_starts,
    systematic_segment_starts_batched,
)

torch.set_num_threads(2)

LW_ATOL, LN_ATOL, ESS_RTOL = 1e-5, 1e-5, 1e-4
# The median final loss of the port over that of the JAX package at (40,
# 400, 40), PGH, the same seed: seeds 0–19 on the CPU gave ratios from
# RATIO_SEEN_LO to RATIO_SEEN_HI, median 1.16 (``python
# tests/test_torch_ensemble.py``): the median over 40 trials of a loss with
# a heavy tail, from streams the two packages do not share. The test allows
# a margin of 2 beyond the wider side (1/0.153 = 6.5).
RATIO_SEEN_LO, RATIO_SEEN_HI = 0.153, 4.13
RATIO_BOUND = 2.0 * max(RATIO_SEEN_HI, 1.0 / RATIO_SEEN_LO)


def _assert_trial_close(lw_t, lw_j, cond):
    """Log-weights of one trial: atol 1e-5 + the conditioning term above
    max − 20 (where the term stays below 1.9e-3), the weight scale
    elsewhere."""
    lw_t, lw_j = np.asarray(lw_t), np.asarray(lw_j)
    live = (lw_j > lw_j.max() - 20.0) & (cond <= 1.9e-3)
    assert np.exp(lw_j[live]).sum() > 0.99
    assert np.all(np.abs(lw_t[live] - lw_j[live]) <= LW_ATOL + cond[live])
    np.testing.assert_allclose(np.exp(lw_t[~live]), np.exp(lw_j[~live]),
                               atol=1e-9)


def _zoo_batch(case, n_trials, n):
    """T banks of one ZOO case (seeds 0..T−1), its experiment repeated per
    trial: (port model, locs (T, N, D), lw (T, N), ep (T, …), outcomes)."""
    _, model_j, box, outcome, ep, _ = case
    banks = [_bank(box, n, seed) for seed in range(n_trials)]
    locs = np.stack([b[0] for b in banks])
    lw = np.stack([b[1] for b in banks])
    ep_t = {k: np.repeat(np.asarray(v), n_trials, axis=0) for k, v in ep.items()}
    outcomes = np.full(n_trials, outcome, np.int32)
    return from_reference(model_j), locs, lw, ep_t, outcomes


@pytest.mark.parametrize("case", [c for c in ZOO if c[0] in (
    "multicos", "known_t2", "binomial_rb", "rb_interleaved", "tomography")],
    ids=lambda c: c[0])
def test_batched_b1_plain_matches_jax_vmap(case):
    """(5, 2048): the port's batched plain update against jax.vmap of the
    JAX fused update in interpret mode (the XLA-equivalent rule)."""
    n_trials, n = 5, 2048
    model_t, locs, lw, ep, outcomes = _zoo_batch(case, n_trials, n)
    tile, scal, cols = model_t.fused_spec_batched(
        torch.from_numpy(outcomes), torch.from_numpy(locs),
        {k: torch.from_numpy(v) for k, v in ep.items()})
    launches = tfu.fused_bayes_update_batched.launches
    lw_t, ln_t, ess_t = tfu.fused_bayes_update_batched(
        tile, scal, torch.from_numpy(lw), cols)
    assert tfu.fused_bayes_update_batched.launches == launches  # CPU: plain
    ep1 = {k: v[:1] for k, v in ep.items()}
    tile_j = _jax_tile(case[1], jnp.asarray(locs[0]), ep1)
    cols_np = [c.numpy() for c in cols]
    lw_j, ln_j, ess_j = jax.vmap(
        lambda s, w, *c: jfu.fused_bayes_update(tile_j, s, w, c,
                                                interpret=True))(
        scal.numpy(), lw, *cols_np)
    for i in range(n_trials):
        _assert_trial_close(lw_t[i].numpy(), lw_j[i],
                            _conditioning(case, locs[i]))
    np.testing.assert_allclose(ln_t.numpy(), np.asarray(ln_j), atol=LN_ATOL)
    np.testing.assert_allclose(ess_t.numpy(), np.asarray(ess_j),
                               rtol=ESS_RTOL)


def _precession_batch(n_trials, n, seed):
    """Banks, per-trial times and outcomes for the precession tile, and
    each trial's conditioning term."""
    rng = np.random.default_rng(seed)
    locs = rng.random((n_trials, n, 1)).astype(np.float32)
    lw = np.log(rng.random((n_trials, n)))
    lw = (lw - np.log(np.exp(lw).sum(1, keepdims=True))).astype(np.float32)
    ts = np.linspace(1.0, 9.0, n_trials).astype(np.float32)
    outcomes = (np.arange(n_trials) % 2).astype(np.int32)
    p1 = 1 - np.cos(0.5 * locs[:, :, 0].astype(np.float64) * ts[:, None]) ** 2
    p1 = np.clip(p1, 1e-300, 1.0)
    k = outcomes[:, None].astype(np.float64)
    cond = 2.0 ** -21 * (k / p1 + (1 - k) / np.maximum(1 - p1, 1e-300))
    return locs, lw, ts, outcomes, cond


@pytest.mark.parametrize("n_trials,n", [(5, 2048), (3, 4096)])
def test_batched_b1_plain_matches_jax_per_trial(n_trials, n):
    """Per-trial times and outcomes: the batched plain update against the
    JAX single-bank interpret call on each trial (the JAX package shows
    that its lax.map rule equals those calls)."""
    locs, lw, ts, outcomes, cond = _precession_batch(n_trials, n, n)
    model = qt.SimplePrecessionModel()
    tile, scal, cols = model.fused_spec_batched(
        torch.from_numpy(outcomes), torch.from_numpy(locs),
        {"t": torch.from_numpy(ts)})
    np.testing.assert_array_equal(
        scal.numpy(), np.stack([outcomes.astype(np.float32), ts], axis=1))
    lw_t, ln_t, ess_t = tfu.fused_bayes_update_batched(
        tile, scal, torch.from_numpy(lw), cols)
    for i in range(n_trials):
        lw_j, ln_j, ess_j = jfu.fused_bayes_update(
            jfu.precession_tile_fn, scal[i].numpy(), jnp.asarray(lw[i]),
            (jnp.asarray(locs[i, :, 0]),), interpret=True)
        _assert_trial_close(lw_t[i].numpy(), lw_j, cond[i])
        assert abs(float(ln_t[i]) - float(ln_j)) <= LN_ATOL
        assert float(ess_t[i]) == pytest.approx(float(ess_j), rel=ESS_RTOL)


@pytest.mark.parametrize("case", ZOO, ids=IDS)
def test_batched_b1_plain_equals_single_bank(case):
    """Each trial of the batched plain update is the single-bank plain
    update on that trial, bit for bit (the kernel's own promise)."""
    model_t, locs, lw, ep, outcomes = _zoo_batch(case, 3, 1003)
    ep_t = {k: torch.from_numpy(v) for k, v in ep.items()}
    locs_t = torch.from_numpy(locs)
    tile, scal, cols = model_t.fused_spec_batched(
        torch.from_numpy(outcomes), locs_t, ep_t)
    lw_b, ln_b, ess_b = tfu.fused_bayes_update_batched(
        tile, scal, torch.from_numpy(lw), cols)
    for i in range(3):
        tile_1, scal_1, cols_1 = model_t.fused_spec(
            int(outcomes[i]), locs_t[i], {k: v[i:i + 1] for k, v in
                                          ep_t.items()})
        assert tile_1 == tile and torch.equal(scal_1, scal[i])
        lw_1, ln_1, ess_1 = tfu.fused_bayes_update(
            tile_1, scal_1, torch.from_numpy(lw[i]), cols_1)
        assert torch.equal(lw_1, lw_b[i]) and torch.equal(ln_1, ln_b[i])
        assert torch.equal(ess_1, ess_b[i])


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


def _b2_batch(n, d, seed):
    """Three trials (random, degenerate, single-heavy weights): starts from
    the port's batched starts, values and per-trial μ."""
    rng = np.random.default_rng(seed)
    log_w = np.stack([_log_weights(k, n, rng)
                      for k in ("random", "degenerate", "single_heavy")])
    u0 = rng.random(3).astype(np.float32)
    starts = systematic_segment_starts_batched(
        torch.from_numpy(log_w), n, u0=torch.from_numpy(u0))
    for i in range(3):  # the batched starts are the single-bank ones
        assert torch.equal(starts[i], systematic_segment_starts(
            torch.from_numpy(log_w[i]), n, u0=float(u0[i])))
    vals = rng.standard_normal((3, n, d)).astype(np.float32)
    mu = rng.standard_normal((3, d)).astype(np.float32)
    return starts, vals, mu


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("d", [1, 3])
def test_batched_b2_plain_matches_jax_vmap(n, d):
    starts, vals, mu = _b2_batch(n, d, n + d)
    out = tre.expand_sorted_segments_batched(starts, torch.from_numpy(vals))
    ref = jax.vmap(lambda s, v: j_expand(s, v, n_out=n, interpret=True))(
        jnp.asarray(starts.numpy()), jnp.asarray(vals))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    shift = (0.02 * mu).astype(np.float32)
    out = tre.expand_sorted_segments_batched(
        starts, torch.from_numpy(vals), scale=0.98,
        shift=torch.from_numpy(shift))
    picked = np.stack([vals[i][np.searchsorted(starts[i].numpy(),
                                               np.arange(n), "right") - 1]
                       for i in range(3)])
    np.testing.assert_array_equal(
        out.numpy(), picked * np.float32(0.98) + shift[:, None, :])
    ref = jax.vmap(lambda s, v, sh: j_expand(
        s, v, n_out=n, interpret=True, scale=np.float32(0.98), shift=sh))(
        jnp.asarray(starts.numpy()), jnp.asarray(vals), jnp.asarray(shift))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n_out", [None, 700])
def test_batched_b2_plain_equals_single_bank(n_out):
    starts, vals, mu = _b2_batch(1000, 2, 5)
    vals_t = torch.from_numpy(vals)
    shift = torch.from_numpy(0.02 * mu)
    launches = tre.expand_sorted_segments_batched.launches
    out = tre.expand_sorted_segments_batched(starts, vals_t, n_out=n_out,
                                             scale=0.98, shift=shift)
    assert tre.expand_sorted_segments_batched.launches == launches
    for i in range(3):
        single = tre.expand_sorted_segments(starts[i], vals_t[i], n_out=n_out,
                                            scale=0.98, shift=shift[i])
        assert torch.equal(out[i], single)
    flat = tre.expand_sorted_segments_batched(starts, vals_t[:, :, 0])
    assert flat.shape == (3, 1000)


def test_batched_kernels_refuse_too_many_trials():
    many = 65536
    lw = torch.zeros((many, 1))
    tile = tfu.two_outcome_tile(tfu.precession_pr1)
    with pytest.raises(ValueError, match="at most 65535 trials"):
        tfu.fused_bayes_update_batched(tile, torch.zeros((many, 2)), lw,
                                       (torch.zeros((many, 1)),))
    with pytest.raises(ValueError, match="at most 65535 trials"):
        tre.expand_sorted_segments_batched(
            torch.zeros((many, 1), dtype=torch.int32), torch.zeros((many, 1)))


# -- the batched step -----------------------------------------------------------

class _Noise:
    """A smear-noise kernel that hands out fixed normals: per trial for a
    single bank, the rows of the given trials for a batch."""

    def __init__(self, noise, trials):
        self.noise, self.trials = noise, trials

    def __call__(self, generator, shape):
        out = self.noise[self.trials]
        return torch.from_numpy(out.reshape(shape))


@pytest.mark.parametrize("fused", [False, True])
def test_batched_step_equals_single_steps(fused):
    """Four trials, two of which fall below the resample threshold: one
    batched step equals four single-bank steps, with the same u0 and smear
    noise injected. Log-weights and evidence to a few ulps; the same
    resample decisions; the resampled clouds to a few ulps (the moments are
    reduced in another order)."""
    n_trials, n = 4, 2048
    rng = np.random.default_rng(0)
    locs = (0.3 + 0.4 * rng.random((n_trials, n, 1))).astype(np.float32)
    lw = np.full((n_trials, n), -np.log(n), np.float32)
    ts = np.array([0.2, 40.0, 0.3, 60.0], np.float32)
    outcomes = np.array([0, 0, 0, 1], np.int32)
    noise = rng.standard_normal((n_trials, n, 1)).astype(np.float32)
    model = qt.SimplePrecessionModel()
    # Long times leave an ESS of about 2N/3, short ones about N.
    config = qt.SMCConfig(resample_thresh=0.9, zero_weight_policy="reset",
                          use_fused_update=fused)

    singles = []
    for i in range(n_trials):
        g = torch.Generator().manual_seed(i)
        st = state_from_numpy(
            {"particle_locations": locs[i], "particle_log_weights": lw[i],
             "n_resamples": 0, "min_n_ess": n, "log_total_likelihood": 0.0,
             "just_resampled": False, "n_zero_weight_events": 0},
            generator=g)
        resampler = qt.LiuWestResampler(kernel=_Noise(noise, i))
        # The single step draws its u0 from the generator: fix it first.
        u0_i = torch.rand((), generator=torch.Generator().manual_seed(i))
        st, ln = qt.smc_update_step(model, resampler, config, st,
                                    int(outcomes[i]), {"t": torch.tensor(
                                        ts[i:i + 1])})
        singles.append((st, ln, float(u0_i)))

    need = [bool(s[0].just_resampled) for s in singles]
    assert need == [False, True, False, True]
    g = torch.Generator().manual_seed(0)
    batch = qt.init_batched_smc_state(g, model, n_trials, n,
                                      qt.UniformDistribution([0, 1]))
    batch = qt.SMCState(
        particle_locations=torch.from_numpy(locs),
        particle_log_weights=torch.from_numpy(lw), generator=g,
        n_resamples=batch.n_resamples, min_n_ess=batch.min_n_ess,
        log_total_likelihood=batch.log_total_likelihood,
        just_resampled=batch.just_resampled,
        n_zero_weight_events=batch.n_zero_weight_events)
    resampler = qt.LiuWestResampler(
        kernel=_Noise(noise, np.flatnonzero(need)))
    u0_all = torch.tensor([s[2] for s in singles])
    out, ln_b = qt.smc_update_step_batched(
        model, resampler, config, batch, torch.from_numpy(outcomes),
        {"t": torch.from_numpy(ts)}, u0=u0_all)
    assert out.just_resampled.tolist() == need
    assert out.n_resamples.tolist() == [int(s[0].n_resamples)
                                        for s in singles]
    for i, (st, ln, _) in enumerate(singles):
        np.testing.assert_allclose(float(ln_b[i]), float(ln), rtol=1e-6)
        np.testing.assert_allclose(out.particle_log_weights[i].numpy(),
                                   st.particle_log_weights.numpy(),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(out.particle_locations[i].numpy(),
                                   st.particle_locations.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(out.min_n_ess[i]),
                                   float(st.min_n_ess), rtol=1e-5)


def test_batched_step_resets_zero_weight_trials_alone():
    """Outcome 1 at t = 0 is impossible: that trial's weights reset to
    uniform and count one zero-weight event; the other trial keeps its
    update."""
    g = torch.Generator().manual_seed(3)
    model = qt.SimplePrecessionModel()
    st = qt.init_batched_smc_state(g, model, 2, 512,
                                   qt.UniformDistribution([0, 1]))
    st, ln = qt.smc_update_step_batched(
        model, qt.LiuWestResampler(),
        qt.SMCConfig(zero_weight_policy="reset", resample_thresh=-1.0), st,
        torch.tensor([1, 1]), {"t": torch.tensor([0.0, 2.0])})
    assert st.n_zero_weight_events.tolist() == [1, 0]
    np.testing.assert_allclose(st.particle_log_weights[0].numpy(),
                               -np.log(512.0), rtol=1e-6)
    assert float(st.particle_log_weights[1].std()) > 0.1
    assert st.just_resampled.tolist() == [False, False]


def test_batched_resample_goes_through_the_b2_wrapper(monkeypatch):
    """``LiuWestResampler.batched`` with ``use_expand_kernel=True`` calls
    the batched B2 wrapper once (on the CPU the wrapper runs its plain
    version); None (the plain pick on a CPU bank) and False give the same
    cloud bit for bit."""
    import qinfer_tpu_torch.resamplers as trs

    rng = np.random.default_rng(5)
    locs = torch.from_numpy(rng.random((3, 1024, 2)).astype(np.float32))
    lw = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    noise = rng.standard_normal((3, 1024, 2)).astype(np.float32)
    u0 = torch.tensor([0.1, 0.5, 0.9])
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return tre.expand_sorted_segments_batched(*args, **kw)

    monkeypatch.setattr(trs, "expand_sorted_segments_batched", spy)
    model = qt.MultiCosModel(n_terms=2)
    out = {}
    for use in (True, None, False):
        rs = qt.LiuWestResampler(kernel=_Noise(noise, slice(None)),
                                 postselect=False, use_expand_kernel=use)
        out[use] = rs.batched(None, model, locs, lw, u0=u0)
    assert calls == [(3, 1024)]
    assert torch.equal(out[True], out[None])
    assert torch.equal(out[True], out[False])


@pytest.mark.parametrize("d", [1, 2])
def test_fused_route_draws_as_the_eager_chain(monkeypatch, d):
    """With kernel B2 and the fused route forced on a CPU bank (the
    wrapper, which launches on CUDA tensors only, stands in by its plain
    version: the resampler's eager chain with the expand kernel off),
    ``batched`` draws
    u0 first and the noise after, as the eager chain does, so one
    generator state gives the same cloud bit for bit; the wrapper gets the
    resampler's a, h and covariance floor, and only the eager chain counts
    as unfused."""
    import qinfer_tpu_torch.resamplers as trs

    rng = np.random.default_rng(9)
    locs = torch.from_numpy(rng.random((3, 512, d)).astype(np.float32))
    lw = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    calls = []

    def spy(log_w, values, u0, a, h, zero_cov_comp):
        calls.append((a, h, zero_cov_comp))
        plain = qt.LiuWestResampler(a=a, h=h, zero_cov_comp=zero_cov_comp,
                                    use_expand_kernel=False)
        return plain._unfused_centers(log_w, values, u0, None)

    monkeypatch.setattr(trs, "liu_west_expand_batched", spy)
    out, unfused = {}, {}
    for fused in (False, True):
        monkeypatch.setattr(trs, "fused_liu_west_route",
                            lambda *args, fused=fused: fused)
        before = qt.LiuWestResampler.unfused_batched
        rs = qt.LiuWestResampler(a=0.95, postselect=False,
                                 zero_cov_comp=1e-4, use_expand_kernel=True)
        out[fused] = rs.batched(torch.Generator().manual_seed(11), None, locs,
                                lw)
        unfused[fused] = qt.LiuWestResampler.unfused_batched - before
    assert torch.equal(out[True], out[False])
    assert unfused == {False: 1, True: 0}
    assert calls == [(0.95, math.sqrt(1.0 - 0.95 ** 2), 1e-4)]


# -- simulator ------------------------------------------------------------------

_SIM_CASES = [
    ("precession", qi.SimplePrecessionModel(), np.array([[0.7]], np.float32),
     {"t": np.array([1.3, 4.0], np.float32)}),
    ("binomial", qi.BinomialModel(qi.SimplePrecessionModel()),
     np.array([[0.4]], np.float32),
     {"t": np.array([2.5], np.float32), "n_meas": np.array([40], np.int32)}),
    ("rb", qi.rb.RandomizedBenchmarkingModel(),
     np.array([[0.95, 0.45, 0.5]], np.float32),
     {"m": np.array([4, 32], np.int32)}),
]


@pytest.mark.parametrize("case", _SIM_CASES, ids=lambda c: c[0])
def test_simulate_experiment_matches_jax_by_moments(case):
    """20000 draws at one parameter on each side: the mean outcome per
    experiment within 5σ of the JAX simulator's, and both within 5σ of the
    exact mean."""
    _, model_j, mp, ep = case
    reps = 20_000
    model_t = from_reference(model_j)
    draws_t = model_t.simulate_experiment(
        torch.Generator().manual_seed(0), torch.from_numpy(mp),
        {k: torch.from_numpy(v) for k, v in ep.items()}, repeat=reps).numpy()
    draws_j = np.asarray(model_j.simulate_experiment(
        jax.random.PRNGKey(0), jnp.asarray(mp),
        {k: jnp.asarray(v) for k, v in ep.items()}, repeat=reps))
    assert draws_t.shape == draws_j.shape == (reps, 1, len(ep[next(iter(ep))]))
    assert draws_t.dtype == np.int32
    base = getattr(model_j, "underlying_model", None) or model_j
    p1 = 1.0 - np.asarray(base.pr0(jnp.asarray(mp), ep), np.float64)[0]
    n_meas = np.asarray(ep.get("n_meas", 1.0), np.float64)
    mean, var = n_meas * p1, n_meas * p1 * (1 - p1)
    se = np.sqrt(var / reps)
    m_t, m_j = draws_t.mean(0)[0], draws_j.mean(0)[0]
    assert np.all(np.abs(m_t - m_j) < 5 * np.sqrt(2) * se + 1e-12)
    assert np.all(np.abs(m_t - mean) < 5 * se + 1e-12)
    assert model_t.sim_count == reps * len(p1)


@pytest.mark.parametrize("model", [
    qt.SimplePrecessionModel(),
    qt.BinomialModel(qt.SimplePrecessionModel()),
    qt.MultiCosModel(n_terms=2),
], ids=lambda m: type(m).__name__)
def test_simulate_trials_pairs_each_trial_with_its_experiment(model):
    """simulate_trials draws trial i at its own parameters and experiment:
    with Pr(1) pushed to 0 or 1 per trial, the draws are exact."""
    n_trials = 6
    d = model.n_modelparams
    mp = torch.full((n_trials, d), 1.0)
    # cos²(t/2 · Σω) is 1 at t = 0 and 0 at t = π (ω sums to 1).
    t = torch.tensor([0.0, np.pi, 0.0, np.pi, np.pi, 0.0], dtype=torch.float32)
    if isinstance(model, qt.MultiCosModel):
        mp = mp / d
        ep = {"ts": t[:, None].expand(n_trials, d).contiguous()}
    else:
        ep = {"t": t}
    if isinstance(model, qt.BinomialModel):
        ep["n_meas"] = torch.arange(1, n_trials + 1, dtype=torch.float32)
    out = model.simulate_trials(torch.Generator().manual_seed(1), mp, ep)
    ones = (t > 0).to(torch.int32)
    if isinstance(model, qt.BinomialModel):
        ones = ones * ep["n_meas"].to(torch.int32)
    assert out.dtype == torch.int32 and torch.equal(out, ones)


# -- perf_test / perf_test_multiple ----------------------------------------------

FIELDS = {"elapsed_time", "loss", "resample_count", "outcome", "true", "est"}
MODEL, PRIOR = qt.SimplePrecessionModel(), qt.UniformDistribution([0.0, 1.0])


def test_result_layout_matches_jax():
    perf_t = qt.perf_test_multiple(3, MODEL, 128, PRIOR, 5, qt.PGH, seed=6,
                                   device="cpu")
    perf_j = qi.perf_test_multiple(3, qi.SimplePrecessionModel(), 128,
                                   qi.UniformDistribution([0.0, 1.0]), 5,
                                   qi.PGH, seed=6)
    assert perf_t.dtype == perf_j.dtype and set(perf_t.dtype.names) == FIELDS
    assert perf_t.shape == perf_j.shape == (3, 5)
    single = qt.perf_test(MODEL, 128, PRIOR, 5, qt.PGH, device="cpu")
    assert single.dtype == perf_j.dtype and single.shape == (5,)
    assert np.all(np.diff(perf_t["resample_count"], axis=1) >= 0)
    assert np.all(perf_t["elapsed_time"] > 0)


def test_loss_falls_tenfold():
    perf = qt.perf_test_multiple(40, MODEL, 400, PRIOR, 40, qt.PGH, seed=12,
                                 device="cpu")
    med_first = np.median(perf["loss"][:, 0])
    med_last = np.median(perf["loss"][:, -1])
    assert med_last < med_first / 10, (med_first, med_last)


def _median_final_losses(seed):
    port = qt.perf_test_multiple(40, MODEL, 400, PRIOR, 40, qt.PGH,
                                 seed=seed, device="cpu")
    ref = qi.perf_test_multiple(40, qi.SimplePrecessionModel(), 400,
                                qi.UniformDistribution([0.0, 1.0]), 40,
                                qi.PGH, seed=seed)
    return (float(np.median(port["loss"][:, -1])),
            float(np.median(ref["loss"][:, -1])))


def test_median_final_loss_matches_jax():
    port, ref = _median_final_losses(12)
    assert 1.0 / RATIO_BOUND < port / ref < RATIO_BOUND, (port, ref)


def test_timing_modes_give_the_same_trajectories():
    agg = qt.perf_test_multiple(4, MODEL, 256, PRIOR, 6, qt.PGH, seed=9,
                                device="cpu")
    per = qt.perf_test_multiple(4, MODEL, 256, PRIOR, 6, qt.PGH, seed=9,
                                device="cpu", timing_mode="per_update")
    for f in ("loss", "outcome", "est", "true", "resample_count"):
        np.testing.assert_array_equal(agg[f], per[f])
    # One uniform value in aggregate mode; per round in per_update mode.
    assert len(np.unique(agg["elapsed_time"])) == 1
    assert len(np.unique(per["elapsed_time"][0])) > 1
    np.testing.assert_array_equal(per["elapsed_time"][0],
                                  per["elapsed_time"][3])


class _RecordingBar:
    def __init__(self):
        self.events = []

    def start(self, max_value):
        self.events.append(("start", max_value))

    def update(self, n):
        self.events.append(("update", n))

    def finished(self):
        self.events.append(("finished",))


@pytest.mark.parametrize("mode", ["aggregate", "per_update"])
def test_progress_bar_lifecycle(mode):
    bar = _RecordingBar()
    perf = qt.perf_test_multiple(3, MODEL, 128, PRIOR, 5, qt.PGH, seed=6,
                                 progressbar=bar, timing_mode=mode,
                                 device="cpu")
    assert perf.shape == (3, 5)
    assert bar.events[0] == ("start", 5) and bar.events[-1] == ("finished",)
    updates = [e for e in bar.events if e[0] == "update"]
    assert updates == ([("update", i + 1) for i in range(5)]
                       if mode == "per_update" else [])


def test_bad_timing_mode_raises():
    with pytest.raises(ValueError, match="timing_mode"):
        qt.perf_test_multiple(2, MODEL, 64, PRIOR, 3, qt.PGH,
                              timing_mode="bogus", device="cpu")


def test_perf_test_per_update_and_other_heuristics():
    perf = qt.perf_test(MODEL, 512, PRIOR, 20, qt.PGH, seed=4,
                        timing_mode="per_update", device="cpu")
    assert perf.shape == (20,) and np.all(perf["elapsed_time"] > 0)
    assert len(np.unique(perf["elapsed_time"])) > 1
    assert perf["est"].shape == (20, 1)
    assert (np.median(perf["loss"][-5:])
            < max(np.median(perf["loss"][:5]), 1e-4) * 5)
    sparse = qt.perf_test(MODEL, 300, PRIOR, 20,
                          lambda u: qt.ExpSparseHeuristic(u), device="cpu")
    assert np.all(np.isfinite(sparse["loss"]))
    fixed = qt.perf_test_multiple(
        3, MODEL, 300, PRIOR, 10, qt.PGH, device="cpu",
        true_prior=qt.ConstantDistribution([0.3]))
    np.testing.assert_array_equal(fixed["true"], 0.3 * np.ones((3, 10, 1),
                                                               np.float32))


def test_entry_points_default_to_the_card():
    """On a host without CUDA, the entry points raise unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.SMCUpdater(MODEL, 16, PRIOR)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.perf_test_multiple(2, MODEL, 16, PRIOR, 2, qt.PGH)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.perf_test(MODEL, 16, PRIOR, 2, qt.PGH, timing_mode="per_update")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    u = qt.SMCUpdater(MODEL, 16, PRIOR, device="cpu")
    assert u.particle_locations.device.type == "cpu"


def _calibrate(n_seeds=20):
    """The ratio of the port's median final loss to the JAX package's at
    (40, 400, 40) over seeds 0..n_seeds−1."""
    ratios = []
    for seed in range(n_seeds):
        port, ref = _median_final_losses(seed)
        ratios.append(port / ref)
        print(f"seed {seed}: port {port:.4g} jax {ref:.4g} "
              f"ratio {port / ref:.4g}", flush=True)
    print(f"ratio min {min(ratios):.4g} max {max(ratios):.4g} "
          f"median {np.median(ratios):.4g}")


if __name__ == "__main__":
    _calibrate(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
