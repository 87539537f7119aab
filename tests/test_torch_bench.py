"""The port's bench entry points (``bench_torch.py``,
``qinfer_tpu_torch.entry``) against the JAX package's (``bench.py``,
``bench_configs.py``, ``__graft_entry__.py``) on the CPU, at small sizes.

The records are held bit for bit against the JAX bench's own; the windows
run the port's plain versions with ``device="cpu"`` and must pass their
gates; ``entry()``'s step is held against the JAX step on the same cloud
within the tolerances of ``test_torch_smc.py``. ``bench_torch.py`` run
as a command finds no card here and must fail with one error line.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import qinfer_tpu.tomography as jt
from test_torch_fused_update import _pr64, assert_log_weights_close
from qinfer_tpu_torch.entry import entry
from qinfer_tpu_torch.interop import state_from_numpy

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import __graft_entry__  # noqa: E402
import bench  # noqa: E402
import bench_configs  # noqa: E402
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 1 << 12


def test_flagship_records_are_bench_py_s():
    for seed in range(bench_torch.N_WINDOWS):
        ts, outcomes = chip_smoke.experiment_record(bench_torch.N_EXP, seed)
        ts_j, outcomes_j = bench._experiment_record(bench.N_EXP, seed)
        assert ts.dtype == ts_j.dtype and outcomes.dtype == outcomes_j.dtype
        np.testing.assert_array_equal(ts, ts_j)
        np.testing.assert_array_equal(outcomes, outcomes_j)
    assert (bench_torch.N_PARTICLES, bench_torch.N_EXP,
            bench_torch.N_WINDOWS, bench_torch.METRIC) == (
        bench.N_PARTICLES, bench.N_EXP, bench.N_WINDOWS, bench.METRIC)
    assert bench_torch.pinned_cpu_pps() == bench._pinned_cpu_pps()


@pytest.mark.parametrize("config,note,make", bench_torch.CONFIG_BENCHES,
                         ids=[f"config{c[0]}" for c in
                              bench_torch.CONFIG_BENCHES])
def test_config_records_are_bench_configs_s(monkeypatch, config, note, make):
    """bench_configs' record, captured from its own ``bench_config{2,3,4}``
    with the timed and emitting functions stubbed out: the outcomes, the
    expparams, the CPU reference's experiments, and its likelihood and
    prior draw on the same inputs."""
    seen = {}

    def tpu_batch_pps(model, prior, outcomes_np, eps_np, n_particles,
                      **kw):
        seen.update(outcomes=outcomes_np, eps=eps_np, n=n_particles)
        return 1.0

    def cpu_reference_pps(likelihood, prior_draw, experiments, n_particles,
                          **kw):
        seen.update(lik=likelihood, draw=prior_draw, exps=experiments)
        return 1.0

    monkeypatch.setattr(bench_configs, "tpu_batch_pps", tpu_batch_pps)
    monkeypatch.setattr(bench_configs, "cpu_reference_pps",
                        cpu_reference_pps)
    monkeypatch.setattr(bench_configs, "emit",
                        lambda c, v, r, n: seen.update(config=c, note=n))
    getattr(bench_configs, f"bench_config{config}")()
    cfg, lik, draw, exps = make()
    assert (seen["config"], seen["note"], seen["n"]) == (config, note,
                                                         bench_torch.N_BIG)
    assert cfg.outcomes.dtype == seen["outcomes"].dtype
    np.testing.assert_array_equal(cfg.outcomes, seen["outcomes"])
    assert cfg.expparams.keys() == seen["eps"].keys()
    for k, v in seen["eps"].items():
        assert cfg.expparams[k].dtype == v.dtype
        np.testing.assert_array_equal(cfg.expparams[k], v)
    assert len(exps) == len(seen["exps"])
    for (o, e), (o_j, e_j) in zip(exps, seen["exps"]):
        assert o == o_j
        np.testing.assert_array_equal(np.asarray(e), np.asarray(e_j))
    locs = draw(np.random.default_rng(5), 64)
    np.testing.assert_array_equal(
        locs, seen["draw"](np.random.default_rng(5), 64))
    for o, e in exps[:6]:
        np.testing.assert_array_equal(lik(o, locs, e),
                                      seen["lik"](o, locs, e))


def test_tile_record_is_bench_configs_s():
    """The window's record: bench_configs' ``record(4·k1)``, the record
    repeated and cut to 96 updates, every field alike."""
    cfg = bench_torch.config3()[0]
    outcomes, eps = bench_torch.tile_record(cfg.outcomes, cfg.expparams,
                                            bench_torch.N_CONFIG_UPDATES)
    assert len(outcomes) == 96 == 4 * 24
    np.testing.assert_array_equal(outcomes[:9], cfg.outcomes)
    np.testing.assert_array_equal(outcomes[90:], cfg.outcomes[:6])
    for k, v in eps.items():
        assert len(v) == 96
        np.testing.assert_array_equal(v[9:18], cfg.expparams[k])


def test_config5_effects_and_truth_match_jax():
    basis = jt.pauli_basis(1)
    true_rho = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]
    projs = [np.array([[0.5, 0.5], [0.5, 0.5]]),
             np.array([[0.5, -0.5j], [0.5j, 0.5]]),
             np.array([[1, 0], [0, 0]])]
    effects = np.stack([np.asarray(basis.state_to_modelparams(
        P.astype(np.complex64)[None]))[0] for P in projs]).astype(np.float32)
    np.testing.assert_allclose(chip_smoke.TRUE_X_1Q, true_x, rtol=0,
                               atol=np.finfo(np.float32).eps)
    np.testing.assert_allclose(chip_smoke.EFFECTS_1Q, effects, rtol=0,
                               atol=np.finfo(np.float32).eps)


def test_flagship_windows_pass_the_gate():
    """Two windows and one repeat at N = 4096 after the warm-up: the gate
    holds in every window (``flagship`` raises otherwise), the bank
    resampled, and no kernel launched on the CPU."""
    line = bench_torch.flagship(N, 2, 1, 0, "cpu")
    assert line["metric"] == bench.METRIC
    assert line["n_windows"] == 2 and line["n_exp"] == 100
    assert line["n_resamples"] >= 1
    assert line["launches"] == dict.fromkeys(
        ("B1", "B1_batched", "B2", "B2_batched", "B2_fused"), 0)
    assert line["value_min"] <= line["value"] <= line["value_max"]


def test_phase_costs_resample_only_when_forced():
    costs = bench_torch.phase_costs(N, 0, "cpu")
    assert len(costs["update_ms_runs"]) == 3
    assert costs["update_ms"] > 0 and costs["resample_ms"] >= 0


@pytest.mark.parametrize("config", [2, 3, 4, 5])
def test_config_windows_pass_their_gates(config):
    """One window after the warm-up at N = 4096: configs 2–4 over the
    record tiled to 96 updates, config 5 its EIG-designed steps; each
    gated inside (``config_windows`` and ``config5_window`` raise)."""
    if config == 5:
        windows = bench_torch.config5_windows(N, 0, "cpu", n_windows=1)
    else:
        make = {c: m for c, _, m in bench_torch.CONFIG_BENCHES}[config]
        windows = bench_torch.config_windows(make()[0], N, 0, "cpu",
                                             n_windows=1)
    assert len(windows) == 1 and windows[0]["n_resamples"] > 0


def test_ensemble_passes_its_gate():
    """The ensemble line at a small shape (8 × 512 × 20), its runs gated."""
    line = bench_torch.ensemble("ensemble_small", 8, 512, 20, device="cpu",
                                runs=1)
    assert line["median_final_loss"] < 1e-3
    assert line["ensemble_pps"] > 0 and len(line["runs"]) == 1


def test_bench_without_a_card_fails_with_one_error_line():
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--which", "flagship"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 1
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.METRIC and "CUDA" in line["error"]


def test_entry_step_matches_the_jax_step():
    """``entry()``'s step on the CPU from the JAX ``entry()``'s cloud: the
    log-weights and evidence within test_torch_smc.py's tolerances
    (``assert_log_weights_close``: atol 1e-4 on the live particles plus
    the cos-conditioning term, exp(lw) within 1e-9 where Pr < 2^-20; 1e-5
    on log_norm); neither resamples."""
    fn_j, (state_j, outcome_j, ep_j) = __graft_entry__.entry()
    new_j, ln_j = jax.jit(fn_j)(state_j, outcome_j, ep_j)
    fn, (state, outcome, ep) = entry(device="cpu")
    assert state.particle_locations.shape == (100_000, 1)
    assert int(outcome) == int(outcome_j)
    np.testing.assert_array_equal(ep["t"].numpy(), np.asarray(ep_j["t"]))
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, state_j))
    new, ln = fn(state, outcome, ep)
    assert int(new.n_resamples) == 0 and int(new_j.n_resamples) == 0
    assert_log_weights_close(
        new.particle_log_weights.numpy(), new_j.particle_log_weights,
        _pr64(np.asarray(state_j.particle_locations)[:, 0], 2.0, 1))
    np.testing.assert_allclose(float(ln), float(ln_j), atol=1e-5)

