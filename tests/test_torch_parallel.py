"""The port's sharded layer (``qinfer_tpu_torch.parallel``) against the JAX
package's ``shard_map`` step and against the port on one bank (CPU).

One module-scoped run starts K = 4 gloo ranks (``_torch_parallel_worker
.py``, the port only, one process each, a file store under ``tmp_path``,
a hard wall-clock limit that kills them all) over a bank of N = 4096
particles made with numpy; each rank writes its block of every scenario.
The JAX package runs the same numpy bank through ``shard_map`` on 4 of the
conftest's 8 virtual CPU devices.

Tolerances: the Bayes update's log-weights and evidence within atol 1e-5
and ``min_n_ess`` within rtol 1e-5 of the port's one-bank step and of the
JAX package's sharded step, as ``tests/test_sharded.py`` holds its own
(the log-weights of particles whose likelihood is tiny by
``test_torch_fused_update``'s criterion, where the two packages' f32 cos
differ); the distributed pick bit-equal to the port's one-bank
``systematic_resample_indices`` at the same u0 (the all-gather route
computes one bank's starts from the gathered log-weights; the ring, whose
normalizer is an all-reduced f64 sum, agrees on this bank), and equal to
the JAX package's but where XLA's FMA moves a start by one (at most
1e-3·N rows, the kept divergence of ROADMAP Queue C); sharded risk and
EIG within rtol 1e-5 of the port's one-bank functions and rtol 1e-4 of
the JAX package's.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import qinfer_tpu as qi
import qinfer_tpu.parallel as jpar
from qinfer_tpu.parallel.sharded_smc import (
    distributed_systematic_pick as j_pick,
)
from qinfer_tpu.smc import SMCConfig as JConfig
from qinfer_tpu.smc import init_smc_state as j_init
import qinfer_tpu_torch as qt
from qinfer_tpu_torch import parallel as par
from qinfer_tpu_torch.interop import state_from_numpy
from qinfer_tpu_torch.parallel.sharded_smc import _cdf_log_norm
from qinfer_tpu_torch.resamplers import systematic_resample_indices
from test_torch_fused_update import _pr64, assert_log_weights_close

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
K = 4
N = 4096
WALL_S = 240  # the workers' whole run; each collective times out at 60 s
PICK_KEY = jax.random.PRNGKey(13)


def _normalized(w):
    return np.log(w / w.sum()).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    skew = np.linspace(0.0, 3.0, N)
    walk_locs = np.stack([rng.random(N), rng.uniform(0.001, 0.05, N)], 1)
    pick_locs = np.stack([np.arange(N), rng.standard_normal(N)], 1)
    return {
        "locs": rng.random((N, 1)).astype(np.float32),
        "lw": _normalized(rng.random(N) ** 3),
        "skew_lw": _normalized(np.exp(skew - skew.max())),
        "pick_lw": _normalized(rng.random(N) ** 2),
        "pick_locs": pick_locs.astype(np.float32),
        "pick_u0": np.float32(jax.random.uniform(PICK_KEY, ())),
        "design_t": np.linspace(0.5, 20.0, 7).astype(np.float32),
        "pgh_steps": 100, "greedy_steps": 80, "greedy_seed": 1,
        "walk_locs": walk_locs.astype(np.float32),
        "walk_t": ((9 / 8) ** (np.arange(20) % 10)).astype(np.float32),
        "walk_outcomes": rng.integers(0, 2, 20).astype(np.int32),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs the K workers once; returns ``load(scenario)``, the list of
    each rank's arrays."""
    out = tmp_path_factory.mktemp("torch_parallel")
    np.savez(out / "inputs.npz", **INPUTS)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    logs = [open(out / f"log{r}.txt", "w") for r in range(K)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(out), str(r), str(K)],
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(REPO), env=env)
        for r in range(K)]
    deadline = time.monotonic() + WALL_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tails = "\n".join((out / f"log{r}.txt").read_text()[-1500:]
                      for r in range(K))
    if late:
        pytest.fail(f"{len(late)} ranks still ran after {WALL_S} s:\n{tails}")
    if any(p.returncode for p in procs):
        pytest.fail(f"a rank failed:\n{tails}")

    def load(name):
        return [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(K)]

    return load


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_particle_mesh(K)


def _jax_state(locs, lw, seed=0):
    st = j_init(jax.random.PRNGKey(seed), qi.SimplePrecessionModel(), N,
                qi.UniformDistribution([0.0, 1.0]))
    return st._replace(particle_locations=jnp.asarray(locs),
                       particle_log_weights=jnp.asarray(lw))


def _bank_state(locs, lw, seed=0):
    """The port's one-bank state of a numpy bank."""
    return state_from_numpy({
        "particle_locations": locs, "particle_log_weights": lw,
        "n_resamples": 0, "min_n_ess": float(len(lw)),
        "log_total_likelihood": 0.0, "just_resampled": False,
        "n_zero_weight_events": 0}, seed=seed)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_update_matches_one_bank_and_jax_shard_map(runs, jmesh, fused):
    """The Bayes update of the sharded step (B1's plain version with its
    raw statistics when fused): within atol 1e-5 (log-weights, evidence)
    and rtol 1e-5 (``min_n_ess``) of the port's one-bank step, and of the
    JAX ``shard_map`` step (Pallas in interpret mode when fused) but for
    the log-weights of particles where Pr(outcome) is tiny, which are held
    by ``test_torch_fused_update``'s criterion (the two packages' f32 cos
    differ there)."""
    ep = np.array([5.0], np.float32)
    step = jpar.make_sharded_update_step(
        jmesh, qi.SimplePrecessionModel(), qi.LiuWestResampler(),
        JConfig(resample_thresh=-1.0, use_fused_update=fused))
    st_j, ln_j = jax.jit(step)(
        jpar.shard_state(_jax_state(INPUTS["locs"], INPUTS["lw"]), jmesh),
        jnp.int32(1), {"t": jnp.asarray(ep)})
    st_t, ln_t = qt.smc_update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0, use_fused_update=fused),
        _bank_state(INPUTS["locs"], INPUTS["lw"]), 1,
        {"t": torch.from_numpy(ep)})
    ranks = runs("update_fused" if fused else "update_unfused")
    lw = _cat(ranks, "lw")
    np.testing.assert_allclose(lw, st_t.particle_log_weights.numpy(),
                               atol=1e-5)
    assert_log_weights_close(lw, st_j.particle_log_weights,
                             _pr64(INPUTS["locs"][:, 0], 5.0, 1))
    for r in ranks:
        for ln, ess in ((ln_t, st_t.min_n_ess), (ln_j, st_j.min_n_ess)):
            np.testing.assert_allclose(r["log_norm"], float(ln), atol=1e-5)
            np.testing.assert_allclose(r["min_n_ess"], float(ess), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_pick(jmesh):
    pick = shard_map(
        lambda key, lw, locs: j_pick(key, lw, locs, "particles"),
        mesh=jmesh, in_specs=(P(), P("particles"), P("particles")),
        out_specs=P("particles"), check_vma=False)
    return np.asarray(jax.jit(pick)(PICK_KEY, jnp.asarray(INPUTS["pick_lw"]),
                                    jnp.asarray(INPUTS["pick_locs"])))


@pytest.mark.parametrize("route", ["all_gather", "expand", "ring",
                                   "past_exact"])
def test_distributed_pick_equals_one_bank(runs, jax_pick, route):
    """Each route's picks are the port's one-bank systematic picks at the
    same u0, bit for bit (the ring's, and the all-gather's past 2^24 rows,
    which take the ring's starts, on this bank); against the JAX
    package's, the rows where a start moved by XLA's FMA are counted."""
    picked = _cat(runs("pick"), route)
    one = systematic_resample_indices(torch.from_numpy(INPUTS["pick_lw"]),
                                      u0=float(INPUTS["pick_u0"])).numpy()
    np.testing.assert_array_equal(picked, INPUTS["pick_locs"][one])
    moved = np.count_nonzero(picked[:, 0] != jax_pick[:, 0])
    assert moved <= 1e-3 * N


@pytest.mark.parametrize("k_shards", [2, 4, 8])
def test_cdf_normalizer_does_not_depend_on_the_split(k_shards):
    """The ring's normalizer (``_cdf_log_norm``) of a bank on one rank and
    the ranks' merge of it (the max of the blocks' maxima, the sum of
    their f64 sums, one rounding) quantize the weights alike, on 200
    banks: the ring's starts do not depend on the number of ranks. The
    two differ only by the f64 sums' order (≈ 1e-16: a normalized bank's
    log-norm is near 0, where f32 keeps that difference)."""
    rng = np.random.default_rng(k_shards)
    for _ in range(200):
        lw = torch.from_numpy(_normalized(rng.random(N) ** 3))
        blocks = lw.reshape(k_shards, -1)
        m = torch.amax(blocks, dim=1).max().to(torch.float64)
        s = sum(torch.sum(torch.exp(b.to(torch.float64) - m)) for b in blocks)
        merged = (m + torch.log(s)).to(torch.float32)
        one = _cdf_log_norm(lw, None)
        assert abs(float(one) - float(merged)) <= 1e-12
        assert torch.equal(torch.round(torch.exp(lw - one) * 2.0 ** 30),
                           torch.round(torch.exp(lw - merged) * 2.0 ** 30))


def test_ring_migration_and_the_auto_switch(runs):
    """The step's ring migration equals its all-gather bit for bit; 'auto'
    takes the all-gather under the byte budget and the ring over it."""
    ranks = runs("migration")
    ring = _cat(ranks, "ring")
    np.testing.assert_array_equal(ring, _cat(ranks, "all_gather"))
    np.testing.assert_array_equal(_cat(ranks, "auto_small"), ring)
    np.testing.assert_array_equal(_cat(ranks, "auto_ring"), ring)
    for r in ranks:
        assert [int(r[f"{m}_ring_calls"]) for m in (
            "all_gather", "ring", "auto_small", "auto_ring")] == [0, 1, 0, 1]
    for name in ("all_gather", "ring", "auto_small", "auto_ring"):
        assert all(int(r["n_resamples"]) == 1
                   for r in runs(f"migration_{name}"))


def test_forced_resample_without_smear_equals_one_bank(runs):
    """h = 0: the sharded resample is the one-bank Liu–West resample of
    the same weights (same u0, the first draw of a generator seeded alike);
    the moments differ only in their order of summation."""
    ranks = runs("resample_h0")
    state = state_from_numpy({
        "particle_locations": INPUTS["locs"],
        "particle_log_weights": _cat(ranks, "lw_pre"),
        "n_resamples": 0, "min_n_ess": 0.0, "log_total_likelihood": 0.0,
        "just_resampled": False, "n_zero_weight_events": 0}, seed=7)
    one = qt.LiuWestResampler(h=0.0)(state.generator, qt.SimplePrecessionModel(),
                                     state.particle_locations,
                                     state.particle_log_weights)
    np.testing.assert_allclose(_cat(ranks, "locs"), one.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_cat(ranks, "lw"), -np.log(N), atol=1e-6)
    assert all(int(r["n_resamples"]) == 1 for r in ranks)


def test_forced_resample_keeps_the_moments(runs):
    """With the smear: mean and variance of the new bank within
    Monte-Carlo error of the weighted ones, every row valid."""
    ranks = runs("resample_smear")
    locs = _cat(ranks, "locs")
    w = np.exp(_cat(ranks, "lw_pre").astype(np.float64))
    x = INPUTS["locs"][:, 0].astype(np.float64)
    mu = w @ x
    var = w @ (x - mu) ** 2
    assert abs(locs.mean() - mu) < 5 * np.sqrt(var / N) + 1e-3
    assert abs(locs.var() / var - 1.0) < 6 / np.sqrt(N) + 0.03
    assert qt.SimplePrecessionModel().are_models_valid(
        torch.from_numpy(locs)).all()


def test_sharded_resample_has_the_resampler_s_spans_and_counters(runs):
    """Under a profiler the sharded resample goes through the resampler's
    own moments, validity test and postselection on every rank: one
    ``qinfer.resamplers.postselect`` and one moments span, each validity
    test inside the postselection and followed by its all-reduced check,
    ``tested_rows`` the block's rows a test; the cloud is the unprofiled
    run's bit for bit."""
    ranks = runs("resample_profiled")
    np.testing.assert_array_equal(_cat(ranks, "locs"),
                                  _cat(runs("resample_smear"), "locs"))
    for r in ranks:
        tests = int(r["count_qinfer.resamplers.valid"])
        assert int(r["count_qinfer.resamplers.postselect"]) == 1
        assert int(r["count_qinfer.resamplers.moments"]) == 1
        assert tests >= 1 and int(r["valid_under_postselect"]) == tests
        assert int(r["count_qinfer.sync.postselect"]) >= tests
        assert int(r["tested_rows"]) == tests * (N // K)


def test_sharded_two_qubit_resample_equals_the_masked_chain(runs):
    """A two-qubit bank's sharded resample (rank-3 states, so that smears
    leave the states and every rank redraws while any holds an invalid
    row), the draws injected: the resampler's loop gives the banks that
    the masked chain with the all-reduced check gave, bit for bit, after
    the same number of whole-block draws on every rank."""
    ranks = runs("resample_tomography_d4")
    np.testing.assert_array_equal(_cat(ranks, "loop"),
                                  _cat(ranks, "masked_chain"))
    draws = {int(r["loop_draws"]) for r in ranks}
    assert draws == {int(r["masked_chain_draws"]) for r in ranks}
    assert len(draws) == 1 and draws.pop() > 2


def test_sharded_two_qubit_resample_through_the_round_kernel(runs):
    """The same resample through the one-launch round (the kernel's source
    built by the host's g++) against the masked chain, the last rank's
    draws zero so that it holds no invalid row: the same draws on every
    rank, the rows within the smear's rounding of the chain's, every rank
    counting the same kernel rounds, and the last rank testing no row in
    them (its rounds walk empty lists) while the others test theirs."""
    ranks = runs("resample_tomography_d4_kernel")
    if not all(r["built"] for r in ranks):
        pytest.skip("no host C++ compiler")
    np.testing.assert_allclose(_cat(ranks, "kernel"),
                               _cat(ranks, "masked_chain"), rtol=0,
                               atol=5e-6)
    draws = {int(r["kernel_draws"]) for r in ranks}
    assert draws == {int(r["masked_chain_draws"]) for r in ranks}
    assert len(draws) == 1 and draws.pop() > 2
    rounds = {int(r["kernel_kernel_rounds"]) for r in ranks}
    assert len(rounds) == 1 and rounds.pop() > 1
    assert all(int(r["masked_chain_kernel_rounds"]) == 0 for r in ranks)
    assert int(ranks[-1]["kernel_rows"]) == 0
    assert all(int(r["kernel_rows"]) > 0 for r in ranks[:-1])
    for r in ranks:
        assert int(r["kernel_tested_rows"]) == N // K + int(r["kernel_rows"])


def test_sharded_sample_splits_by_weight(runs):
    ranks = runs("sample")
    draws = ranks[0]["draws"][:, 0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["draws"][:, 0], draws)
    assert set(np.unique(draws)) <= {10.0, 100.0}
    assert abs(np.mean(draws == 10.0) - 0.75) < 0.1


@pytest.mark.parametrize("name", ["precession", "binomial"])
def test_sharded_design_matches_one_bank_and_jax(runs, jmesh, name):
    """Streaming (precession) and general (BinomialModel) routes."""
    t = INPUTS["design_t"]
    model_t = qt.SimplePrecessionModel()
    model_j = qi.SimplePrecessionModel()
    cand = {"t": t}
    if name == "binomial":
        model_t, model_j = qt.BinomialModel(model_t), qi.BinomialModel(model_j)
        cand["n_meas"] = np.full(len(t), 10, np.int32)
    ranks = runs(f"design_{name}")
    state = state_from_numpy({
        "particle_locations": INPUTS["locs"],
        "particle_log_weights": INPUTS["lw"], "n_resamples": 0,
        "min_n_ess": 0.0, "log_total_likelihood": 0.0,
        "just_resampled": False, "n_zero_weight_events": 0})
    cand_t = {k: torch.from_numpy(v) for k, v in cand.items()}
    outcomes = model_t.all_outcomes(cand_t)
    one = {"risk": qt.bayes_risk_fn(model_t, state, cand_t, model_t.Q,
                                    outcomes).numpy(),
           "eig": qt.expected_information_gain_fn(model_t, state, cand_t,
                                                  outcomes).numpy()}
    risk_j, eig_j = jpar.make_sharded_expdesign(jmesh, model_j)
    jstate = jpar.shard_state(_jax_state(INPUTS["locs"], INPUTS["lw"]), jmesh)
    cand_j = {k: jnp.asarray(v) for k, v in cand.items()}
    ref = {"risk": np.asarray(risk_j(jstate, cand_j)),
           "eig": np.asarray(eig_j(jstate, cand_j))}
    for r in ranks:
        np.testing.assert_array_equal(r["risk"], ranks[0]["risk"])
        np.testing.assert_array_equal(r["eig"], ranks[0]["eig"])
    for key in ("risk", "eig"):
        np.testing.assert_allclose(ranks[0][key], one[key], rtol=1e-5)
        np.testing.assert_allclose(ranks[0][key], ref[key], rtol=1e-4)


def _records_agree(ranks, n_exp, d, fields):
    for r in ranks:
        for key in r:
            np.testing.assert_array_equal(r[key], ranks[0][key])
    rec = ranks[0]
    assert rec["rec_log_norm"].shape == (n_exp,)
    assert rec["rec_est_mean"].shape == rec["rec_true"].shape == (n_exp, d)
    for name, shape in fields.items():
        assert rec[f"rec_ep_{name}"].shape == (n_exp,) + shape
    assert np.all(np.isfinite(rec["rec_log_norm"]))
    return rec


def test_pgh_episode_gate_and_records(runs):
    """config1_quickstart_pgh's loop over the sharded bank: 100 PGH steps,
    gated as on the card (|est − 0.512| < 6σ + 1e-3)."""
    rec = _records_agree(runs("episode_pgh"), int(INPUTS["pgh_steps"]), 1,
                         {"t": ()})
    sd = float(np.sqrt(rec["cov"][0, 0]))
    assert rec["finite"] and int(rec["n_resamples"]) > 0
    assert abs(float(rec["mean"][0]) - 0.512) < 6 * sd + 1e-3
    np.testing.assert_array_equal(rec["rec_true"], np.float32(0.512))


def test_greedy_episode_gate_and_records(runs):
    """config5_adaptive_tomography's loop over the sharded bank: 80 greedy
    EIG steps over three effects, gated as on the card."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rec = _records_agree(runs("episode_greedy"), int(INPUTS["greedy_steps"]),
                         4, {"meas": (4,)})
    spread = float(np.sqrt(np.trace(rec["cov"])))
    err = float(np.linalg.norm(rec["mean"] - chip_smoke.TRUE_X_1Q))
    assert rec["valid"] and int(rec["n_resamples"]) > 0
    assert err < chip_smoke.Z_1Q * spread and spread < chip_smoke.SPREAD_1Q


def test_random_walk_without_resample_moves_as_one_bank(runs):
    """A learned-σ walk that never resamples: every rank draws the time
    step's noise for the whole bank from the replicated generator, so the
    particles move bit for bit as one bank's; the weights agree to the
    order of summation."""
    walk = qt.GaussianRandomWalkModel(qt.SimplePrecessionModel(),
                                      diagonal=True)
    state = state_from_numpy({
        "particle_locations": INPUTS["walk_locs"],
        "particle_log_weights": INPUTS["lw"], "n_resamples": 0,
        "min_n_ess": float(N), "log_total_likelihood": 0.0,
        "just_resampled": False, "n_zero_weight_events": 0}, seed=3)
    config = qt.SMCConfig(resample_thresh=-1.0)
    for t, outcome in zip(INPUTS["walk_t"], INPUTS["walk_outcomes"]):
        state, log_norm = qt.smc_update_step(
            walk, qt.LiuWestResampler(), config, state, int(outcome),
            {"t": torch.tensor([float(t)])})
    ranks = runs("walk")
    np.testing.assert_array_equal(_cat(ranks, "locs"),
                                  state.particle_locations.numpy())
    np.testing.assert_allclose(_cat(ranks, "lw"),
                               state.particle_log_weights.numpy(), atol=1e-5)
    np.testing.assert_allclose(ranks[0]["log_norm"], float(log_norm),
                               atol=1e-5)


def test_direct_view_equals_serial(runs):
    """Above the threshold each rank evaluates N/K rows and the gathered
    likelihood equals the serial one; below it, and when N does not split,
    every rank evaluates all rows. The step through the wrapper equals the
    serial step."""
    model = qt.SimplePrecessionModel()
    outcomes = torch.tensor([0, 1])
    ep = {"t": torch.tensor([5.0])}
    for r in runs("direct_view"):
        for m, rows in ((N, [N // K]), (64, [64]), (N - 2, [N - 2])):
            serial = model.likelihood(
                outcomes, torch.from_numpy(INPUTS["locs"][:m]), ep).numpy()
            np.testing.assert_array_equal(r[f"n{m}"], serial)
            assert r[f"rows{m}"].tolist() == rows
        state = state_from_numpy({
            "particle_locations": INPUTS["locs"],
            "particle_log_weights": INPUTS["lw"], "n_resamples": 0,
            "min_n_ess": float(N), "log_total_likelihood": 0.0,
            "just_resampled": False, "n_zero_weight_events": 0})
        st, log_norm = qt.smc_update_step(
            model, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0),
            state, 1, ep)
        np.testing.assert_array_equal(r["step_lw"],
                                      st.particle_log_weights.numpy())
        assert float(r["step_log_norm"]) == float(log_norm)


def test_meshes_and_replicate(runs):
    for rank, r in enumerate(runs("mesh")):
        assert bool(r["uneven_refused"])
        trials = rank // 2  # host_local_mesh(2): (trials, particles) = 2 × 2
        np.testing.assert_array_equal(r["trial_seeds"],
                                      np.arange(8)[4 * trials:4 * trials + 4])
        assert int(r["particle_rank"]) == rank % 2
        np.testing.assert_array_equal(r["replicated"], 0.0)


@pytest.mark.parametrize("name", [
    "update_unfused", "update_fused", "migration_all_gather",
    "migration_ring", "resample_h0", "resample_smear", "walk"])
def test_replicated_scalars_are_identical_on_every_rank(runs, name):
    ranks = runs(name)
    for key in ("log_norm", "n_resamples", "min_n_ess",
                "log_total_likelihood", "just_resampled",
                "n_zero_weight_events"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key])


def test_no_process_group():
    """Without a process group the mesh refuses and the wrapper model
    evaluates serially."""
    with pytest.raises(RuntimeError, match="process group"):
        par.make_particle_mesh(device_type="cpu")
    model = qt.SimplePrecessionModel()
    wrapped = par.DirectViewParallelizedModel(underlying_model=model)
    assert not wrapped.fused_update_supported
    mp = torch.from_numpy(INPUTS["locs"])
    ep = {"t": torch.tensor([2.0])}
    np.testing.assert_array_equal(
        wrapped.likelihood(torch.tensor([0, 1]), mp, ep).numpy(),
        model.likelihood(torch.tensor([0, 1]), mp, ep).numpy())


def test_parallel_names_match_the_jax_package():
    assert set(par.__all__) == set(jpar.__all__)
    assert qt.DirectViewParallelizedModel is par.DirectViewParallelizedModel


def test_chip_sharded_script_on_two_gloo_ranks():
    """``chip_sharded.py``, the check of the sharded layer across cards,
    on two gloo ranks of the CPU at N = 4096: every phase passes on every
    rank, its dry run of every sharded path and config 5's
    ``main_sharded`` too; then its scaling phase, a world of one rank and
    one of two at 1024 particles a rank, prints the inventory and
    throughput rows. Its ranks share the script's process group, which is
    killed whole if the run outlives its limit."""
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_sharded.py"), "--cpu", "2", "--n",
         str(N), "--per-shard", "1024"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=str(REPO), env=dict(os.environ, OMP_NUM_THREADS="1"),
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=WALL_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"chip_sharded.py still ran after {WALL_S} s")
    assert proc.returncode == 0, err[-3000:]
    lines = [json.loads(line) for line in out.splitlines()[:-1]]
    ranks = [r for r in lines if "rank" in r]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["pick"]["ring_rows_differing"] == 0 for r in ranks)
    # entry.dryrun_multichip on every rank: every sharded path, the trials
    # axis's episodes gathered to (2·world, 4) losses.
    for r in ranks:
        assert r["dryrun"]["ok"] and r["dryrun"]["world_size"] == 2
        assert r["dryrun"]["trials_loss_shape"] == [4, 4]
        assert r["dryrun"]["all_gather"] == r["dryrun"]["ring"] == 1
        assert r["config5_sharded"]["ok"]
    assert ranks[0]["dryrun"] == ranks[1]["dryrun"]
    assert ranks[0]["config5_sharded"] == ranks[1]["config5_sharded"]
    scaling = [r["metric"] for r in lines if "metric" in r]
    assert scaling == [
        "collective_bytes_per_step", "collective_bytes_per_step",
        "sharded_particle_updates_per_s@1dev",
        "collective_bytes_per_step", "collective_bytes_per_step",
        "sharded_particle_updates_per_s@2dev"]
    assert json.loads(out.splitlines()[-1]) == {"ok": True, "world_size": 2}
