"""The cell ``tomography_3q_batch`` at sizes a test run can hold on the
CPU: its reference loads nothing of the system; its driver's records and
truths; a run of its driver comes out correct and reports the new
metrics; the control (the plain reference computed in bfloat16 in the
program's place) and each planted fault come out not correct; the new
readers on a synthetic recording."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _paths
import faults_3q
from harness import registry, runner, window

CELL = "tomography_3q_batch"
TINY = dict(n_particles=4096, check_span_units=1, check_steps=6,
            check_units=1, check_resamples=4, trace_seconds=0.1)
SEED = 2 ** 33 + 23
NEW = ("b1_wide_update_share", "clamp_resample_share")


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
        "registry.Registry().module('reference', 'tomography_3q')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qinfer_tpu_torch', 'qinfer_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(bad)\n" % _paths.FOLDER)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_the_records_and_truths_are_drawn_from_the_seed():
    cell = _cell()
    mod = cell.module("drivers", cell.traffic["driver"])
    ref = cell.module("reference", "tomography_3q")

    def coords(rho):
        flat = torch.from_numpy(np.ascontiguousarray(rho.reshape(-1, 8, 8)))
        return ref.coords(flat).numpy().reshape(rho.shape[:-2] + (64,))

    a = mod.records(SEED, 20, 216, 50, 16, coords)
    b = mod.records(SEED, 20, 216, 50, 16, coords)
    c = mod.records(SEED + 1, 20, 216, 50, 16, coords)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    effects, counts, truths = a
    assert effects.shape == (20, 216, 64) and counts.shape == (20, 216)
    assert effects.dtype == np.float32 and counts.dtype == np.int32
    assert counts.min() >= 0 and counts.max() <= 50
    # Every truth has the GHZ mixture's spectrum; each block of 16 units
    # holds every truth once.
    lam = torch.linalg.eigvalsh(ref.density(torch.from_numpy(truths)))
    np.testing.assert_allclose(lam.numpy(), np.tile(
        [0.0125] * 7 + [0.9125], (20, 1)), atol=1e-12)
    assert len({tuple(np.round(t, 9)) for t in truths[:16]}) == 16
    # Effects: rank-one projectors of trace one, so Pr(1) lies in [0, 1].
    rho = ref.density(torch.from_numpy(effects[0].astype(np.float64)))
    np.testing.assert_allclose(torch.linalg.eigvalsh(rho).numpy(), np.tile(
        [0.0] * 7 + [1.0], (216, 1)), atol=1e-6)
    trace = np.einsum("nii->n", rho.numpy()).real
    np.testing.assert_allclose(trace, 1.0, atol=1e-6)
    # Product projectors: each is the Kronecker product of its partial
    # traces (rank one on each qubit).
    r = rho.numpy().reshape(216, 2, 4, 2, 4)
    first = np.einsum("nikjk->nij", r)
    rest = np.einsum("nkikj->nij", r)
    np.testing.assert_allclose(
        np.einsum("nij,nkl->nikjl", first, rest).reshape(216, 8, 8),
        rho.numpy(), atol=1e-6)


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
    for name in NEW + ("valid_host_us", "valid_rows_per_resample",
                       "clamped_rows_per_resample", "step_host_us",
                       "b1_host_us", "resample_host_us", "sync_wait_us"):
        assert name in metrics, name
    # B1's plain version on the CPU launches nothing: no wide launch.
    assert metrics["b1_wide_update_share"]["value"] == 0.0
    assert 0.0 <= metrics["clamp_resample_share"]["value"] <= 100.0
    assert "valid_kernel_row_share" not in metrics
    assert "redraw_kernel_round_share" not in metrics


def test_the_checked_unit_keeps_the_first_resampling_steps():
    cell = _cell()
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(cell, SEED,
                                                                "cpu")
    drv._unit(0, set(), True)
    assert len(drv.kept) == TINY["check_resamples"]
    assert all(st["resampled"] and not st["sampled"] for st in drv.kept)
    assert len(drv.finals) == 1
    drv._reset()
    drv._unit(0, {5, 100}, False)
    assert [st["step"] for st in drv.kept] == [5, 100]


def test_the_control_fails():
    """At 4096 particles the control fails the update's, the evidence's
    and the guarantee's limits; the moment gaps, in standard errors that
    shrink as 1/√n, fail at the cell's own size (``control.py`` on the
    card)."""
    cell = _cell()
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(cell, SEED,
                                                                "cpu")
    drv.setup()
    window.run(drv, 0.2, device="cpu")
    drv.release()
    checks = {c.name: c for c in drv.check(control=True)}
    for name in ("update_gap", "evidence_gap", "invalid_states"):
        assert not checks[name].ok, (name, checks[name].value)


@pytest.mark.parametrize("fault", sorted(faults_3q.FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    for obj, attr, new in faults_3q.patches(fault):
        monkeypatch.setattr(obj, attr, new)
    res = _run(_cell())
    assert res["correct"] is False, (fault, res["checks"])
    assert res["failed"] >= 1


def _agg(total, count=1):
    return {"count": count, "total_ns": total, "self_ns": total,
            "parents": {}}


def test_the_new_readers_on_a_synthetic_recording():
    reg = registry.Registry()
    wide = reg.module("metrics", "b1_wide_update_share")
    clamp = reg.module("metrics", "clamp_resample_share")
    rec = {"counters": {"smc.steps": 40,
                        "ops.fused_bayes_update.wide_launches": 40,
                        "resamplers.LiuWestResampler.clamped_resamples": 3},
           "spans": {"qinfer.resamplers.postselect": _agg(900_000, 12)}}
    assert wide.value(rec) == pytest.approx(100.0)
    assert clamp.value(rec) == pytest.approx(25.0)
    # No wide launch and no clamp in the stretch: both read 0.
    none = {"counters": {"smc.steps": 40},
            "spans": {"qinfer.resamplers.postselect": _agg(900_000, 12)}}
    assert wide.value(none) == 0.0
    assert clamp.value(none) == 0.0
    # No step and no resample: nothing to read.
    empty = {"counters": {}, "spans": {}}
    assert wide.value(empty) is None
    assert clamp.value(empty) is None
    # The program's own record, read through ``read``.
    assert wide.read(None) is None or wide.read(None) >= 0.0
    assert clamp.read(None) is None or clamp.read(None) >= 0.0
