"""What decides ``correct``, at sizes a test run can hold on the CPU: a
sound run comes out correct; the control (the plain reference put in the
program's place and computed in bfloat16) comes out over the limits; and
with the timed path broken underneath (``faults.py``) the rest of a run,
the harness's look for a card skipped, comes out not correct, once for
each fault the cell can have."""

import time

import pytest

import _paths  # noqa: F401
import faults
from harness import registry, runner, window

TINY = {
    "precession_batch_1M": dict(n_particles=8192, check_units=3),
    "tomography_adaptive_eig_1M": dict(
        n_particles=262144, steps=10, check_span_units=1, check_steps=8,
        check_units=1),
    "precession_ensemble_256x2048": dict(
        trials=8, particles=2048, n_exp=100, check_span_units=1,
        check_units=1, check_trials=8),
}
CELL_FAULTS = {
    "precession_batch_1M": ["unchanged_step", "altered_answer"],
    "tomography_adaptive_eig_1M": ["unchanged_step", "altered_answer",
                                   "wrong_rows", "broken_smear"],
    "precession_ensemble_256x2048": ["unchanged_step", "half_batch",
                                     "altered_answer"],
}
SEED = 2 ** 31 + 77


def _cell(name):
    cell = registry.Registry(held=True).cell(name)
    cell.traffic.update(TINY[name])
    return cell


def _run(cell):
    return runner.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    res = _run(_cell(name))
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails(name):
    cell = _cell(name)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(cell, SEED,
                                                                "cpu")
    drv.setup()
    window.run(drv, 0.2, device="cpu")
    drv.release()
    checks = drv.check(control=True)
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(CELL_FAULTS)
                                        for f in CELL_FAULTS[n]])
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = _cell(name)
    for obj, attr, new in faults.patches(fault):
        monkeypatch.setattr(obj, attr, new)
    res = _run(cell)
    assert res["correct"] is False, (fault, res["checks"])
    assert res["failed"] >= 1
