"""The cell ``tomography_2q_batch`` at sizes a test run can hold on the
CPU: its reference loads nothing of the system; a run of its driver comes
out correct and reports the resampler's new metrics; the control (the
plain reference computed in bfloat16 in the program's place) and each
planted fault come out not correct; the new readers on a synthetic
recording."""

import json
import subprocess
import sys
import time

import pytest

import _paths
import faults
import faults_2q
from harness import registry, runner, window

CELL = "tomography_2q_batch"
TINY = dict(n_particles=4096, check_span_units=1, check_steps=8,
            check_units=1, trace_seconds=0.1)
SEED = 2 ** 33 + 19
NEW = ("valid_host_us", "valid_rows_per_resample",
       "clamped_rows_per_resample")


def _cell():
    cell = registry.Registry().cell(CELL)
    cell.traffic.update(TINY)
    return cell


def _run(cell, trace=False):
    return runner.run_cell(cell, SEED, 0.2, trace, "cpu", time.perf_counter())


def test_the_reference_loads_nothing_of_the_system():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from harness import registry\n"
        "registry.Registry().module('reference', 'tomography_2q')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qinfer_tpu_torch', 'qinfer_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(bad)\n" % _paths.FOLDER)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_the_records_are_drawn_from_the_seed():
    cell = _cell()
    mod = cell.module("drivers", cell.traffic["driver"])
    ref = cell.module("reference", "tomography_2q")
    import numpy as np
    import torch

    def coords(rho):
        flat = torch.from_numpy(np.ascontiguousarray(rho.reshape(-1, 4, 4)))
        return ref.coords(flat).numpy().reshape(rho.shape[:-2] + (16,))

    a = mod.records(SEED, 20, 120, 50, 16, coords)
    b = mod.records(SEED, 20, 120, 50, 16, coords)
    c = mod.records(SEED + 1, 20, 120, 50, 16, coords)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    effects, counts, truths = a
    assert effects.shape == (20, 120, 16) and counts.shape == (20, 120)
    assert counts.min() >= 0 and counts.max() <= 50
    # Every truth has the source's spectrum; each block of 16 units holds
    # every truth once.
    lam = torch.linalg.eigvalsh(ref.density(torch.from_numpy(truths)))
    np.testing.assert_allclose(lam.numpy(), np.tile(
        [0.025, 0.025, 0.025, 0.925], (20, 1)), atol=1e-12)
    assert len({tuple(np.round(t, 9)) for t in truths[:16]}) == 16
    # Projectors: rank one, trace one, Pr(1) within [0, 1].
    rho = ref.density(torch.from_numpy(effects[0].astype(np.float64)))
    np.testing.assert_allclose(torch.linalg.eigvalsh(rho).numpy(), np.tile(
        [0.0, 0.0, 0.0, 1.0], (120, 1)), atol=1e-6)


def test_a_sound_run_is_correct_and_reports_the_new_metrics():
    """A short traced run, in a fresh process, with B1's plain version on
    the step's path."""
    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "from harness import registry, runner\n"
        "cell = registry.Registry().cell(%r)\n"
        "cell.traffic.update(json.loads(%r))\n"
        "cell.config['smc']['use_fused_update'] = True\n"
        "res = runner.run_cell(cell, %d, 0.3, True, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(res))\n"
        % (_paths.FOLDER, _paths.ROOT, CELL, json.dumps(TINY), SEED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True,
                         cwd=_paths.ROOT).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    assert set(res["checks"]) == {"update_gap", "evidence_gap",
                                  "resample_mean_z", "resample_cov_z",
                                  "invalid_states"}
    metrics = res["metrics"]
    for name in NEW + ("step_host_us", "b1_host_us", "resample_host_us",
                       "sync_wait_us"):
        assert name in metrics, name
    assert metrics["valid_rows_per_resample"]["value"] >= TINY["n_particles"]
    assert metrics["valid_host_us"]["value"] > 0
    assert metrics["valid_host_us"]["value"] < metrics[
        "resample_host_us"]["value"] + metrics["sync_wait_us"]["value"]
    assert metrics["clamped_rows_per_resample"]["value"] >= 0


def test_the_control_fails():
    cell = _cell()
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(cell, SEED,
                                                                "cpu")
    drv.setup()
    window.run(drv, 0.2, device="cpu")
    drv.release()
    checks = drv.check(control=True)
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]


PLANTED = [(faults, "unchanged_step"), (faults, "altered_answer"),
           (faults, "wrong_rows"), (faults_2q, "smear_without_root"),
           (faults_2q, "postselect_unchecked")]


@pytest.mark.parametrize("module,fault", PLANTED,
                         ids=[f for _, f in PLANTED])
def test_a_planted_fault_is_not_correct(module, fault, monkeypatch):
    for obj, attr, new in module.patches(fault):
        monkeypatch.setattr(obj, attr, new)
    res = _run(_cell())
    assert res["correct"] is False, (fault, res["checks"])
    assert res["failed"] >= 1


def _agg(total, count=1):
    return {"count": count, "total_ns": total, "self_ns": total,
            "parents": {}}


def test_the_new_readers_on_a_synthetic_recording():
    reg = registry.Registry()
    rec = {"counters": {"smc.steps": 10,
                        "resamplers.LiuWestResampler.tested_rows": 12000,
                        "resamplers.LiuWestResampler.clamped_rows": 6},
           "spans": {"qinfer.resamplers.valid": _agg(400_000, 12),
                     "qinfer.resamplers.postselect": _agg(900_000, 2)}}
    want = {"valid_host_us": 40.0, "valid_rows_per_resample": 6000.0,
            "clamped_rows_per_resample": 3.0}
    for name, value in want.items():
        reader = reg.module("metrics", name)
        assert reader.value(rec) == pytest.approx(value), name
        # a program without these spans and counters: nothing to read
        assert reader.value({"counters": {"smc.steps": 10},
                             "spans": {}}) is None, name
    none_clamped = dict(rec, counters={
        k: v for k, v in rec["counters"].items() if "clamped" not in k})
    assert reg.module("metrics", "clamped_rows_per_resample").value(
        none_clamped) == 0.0
