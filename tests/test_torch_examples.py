"""The twins of ``examples/`` (``examples_torch/``) on the CPU.

Configs 2 and 3: the same NumPy record goes through the JAX example's
``main`` and the twin's; the posterior means agree within 4 joint
posterior standard deviations, parameter by parameter. Configs 1, 4 and
5: each twin's own assert passes at a reduced ``n_exp``. Config 5's
``main_sharded`` runs on two gloo ranks, a process each.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from examples_torch import (  # noqa: E402
    config1_precession_quickstart,
    config2_binomial_estimation,
    config3_randomized_benchmarking,
    config4_multiparameter_hamiltonian,
    config5_adaptive_tomography,
)

torch.set_num_threads(2)


def _jax_example(name):
    """``examples/<name>.py`` loaded under a module name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _moments(updater):
    return (np.asarray(updater.est_mean(), np.float64),
            np.asarray(updater.est_covariance_mtx(), np.float64))


def _agree(mean_j, cov_j, mean_t, cov_t, sds=4.0):
    joint = np.sqrt(np.diag(cov_j) + np.diag(cov_t))
    assert np.all(np.abs(mean_j - mean_t) < sds * joint), (
        mean_j, mean_t, joint)


def test_config2_matches_the_jax_example():
    mean_j, cov_j = _moments(
        _jax_example("config2_binomial_estimation").main())
    u = config2_binomial_estimation.main(device="cpu")
    mean_t, cov_t = (m.numpy() for m in (u.est_mean(),
                                         u.est_covariance_mtx()))
    _agree(mean_j, cov_j, mean_t, cov_t)


def test_config3_matches_the_jax_example():
    mean_j, cov_j = _jax_example("config3_randomized_benchmarking").main()
    mean_t, cov_t = config3_randomized_benchmarking.main(device="cpu")
    assert mean_t.shape == (3,) and cov_t.shape == (3, 3)
    _agree(np.asarray(mean_j), np.asarray(cov_j), mean_t, cov_t)


def test_config1_passes_its_assert():
    u = config1_precession_quickstart.main(n_exp=40, device="cpu")
    assert u.resample_count > 0 and u.device.type == "cpu"


@pytest.mark.parametrize("which", ["known_t2", "multicos"])
def test_config4_passes_its_assert(which):
    u = getattr(config4_multiparameter_hamiltonian, which)(n_exp=40,
                                                           device="cpu")
    assert torch.isfinite(u.est_mean()).all()


def test_config5_passes_its_assert():
    u = config5_adaptive_tomography.main(n_exp=30, device="cpu")
    assert u.resample_count > 0


def test_config5_sharded_on_two_gloo_ranks(monkeypatch):
    """``main_sharded`` on two ranks, 60 steps: each rank passes the
    example's assert (err < 0.2 and a third of the first step's), and the
    ranks agree."""
    monkeypatch.chdir(REPO)
    run = config5_adaptive_tomography.run_sharded(2, cpu=2, n_exp=60,
                                                  wall_s=240)
    assert run.ok, run.failure()
    r0, r1 = run.results
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert {k: v for k, v in r0.items() if k != "rank"} == {
        k: v for k, v in r1.items() if k != "rank"}
    assert r0["err"] < 0.2 and r0["err"] < r0["err0"] / 3
