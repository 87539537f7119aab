"""One-call estimation API on torch tensors.

Counterpart of ``qinfer_tpu/simple_est.py``: ``load_data_or_txt``,
``simple_est_prec`` and ``simple_est_rb``. Each builds a model, a prior and
an ``SMCUpdater`` on ``device`` (the card unless the caller asks for the
CPU), replays the record with ``batch_update`` and returns (mean, cov) as
numpy arrays, or (mean, cov, extra) with ``return_all``. ``extra`` holds
only ``{'updater': ...}``, as in the JAX package (a known defect of the
reference, kept).
"""

from __future__ import annotations

import io

import numpy as np

from .distributions import PostselectedDistribution, UniformDistribution
from .models.derived import BinomialModel
from .models.rb import RandomizedBenchmarkingModel
from .models.test_models import SimplePrecessionModel
from .smc import SMCUpdater

__all__ = ["simple_est_prec", "simple_est_rb", "load_data_or_txt"]


def load_data_or_txt(data, cols):
    """(n_rows, cols) float data from an array, CSV text, a path or a file."""
    if isinstance(data, (np.ndarray, list, tuple)):
        arr = np.asarray(data, dtype=float)
    elif isinstance(data, str):
        try:
            arr = np.loadtxt(io.StringIO(data), delimiter=",")
        except ValueError:
            arr = np.loadtxt(data, delimiter=",")
    elif hasattr(data, "read"):
        arr = np.loadtxt(data, delimiter=",")
    else:
        raise TypeError(f"Cannot load data from {type(data)}.")
    arr = np.atleast_2d(arr)
    if arr.shape[1] != cols:
        raise ValueError(f"Expected {cols} columns, got {arr.shape[1]}.")
    return arr


def _result(updater, return_all):
    mean = updater.est_mean().cpu().numpy()
    cov = updater.est_covariance_mtx().cpu().numpy()
    if return_all:
        return mean, cov, {"updater": updater}
    return mean, cov


def simple_est_prec(data, freq_min=0.0, freq_max=1.0, n_particles=6000,
                    return_all=False, seed=0, device="cuda"):
    """Frequency estimation from (counts, t, n_shots) records."""
    arr = load_data_or_txt(data, 3)
    counts, ts, n_shots = arr[:, 0], arr[:, 1], arr[:, 2]
    model = BinomialModel(SimplePrecessionModel(min_freq=freq_min))
    prior = UniformDistribution([freq_min, freq_max])
    updater = SMCUpdater(model, n_particles, prior, seed=seed, device=device)
    updater.batch_update(counts.astype(np.int32),
                         {"t": ts.astype(np.float32),
                          "n_meas": n_shots.astype(np.float32)})
    return _result(updater, return_all)


def simple_est_rb(data, interleaved=False, p_min=0.0, p_max=1.0,
                  n_particles=8000, return_all=False, seed=0, device="cuda"):
    """RB decay estimation from (counts, m, n_shots[, reference]) records.
    Model parameters (p, A, B), or (p̃, p_ref, A, B) interleaved, under a
    uniform box prior postselected to the physical region."""
    n_cols = 4 if interleaved else 3
    arr = load_data_or_txt(data, n_cols)
    counts, ms, n_shots = arr[:, 0], arr[:, 1], arr[:, 2]
    model = RandomizedBenchmarkingModel(interleaved=interleaved)
    n_p = 2 if interleaved else 1
    box = [[p_min, p_max]] * n_p + [[0.0, 1.0], [0.0, 1.0]]
    prior = PostselectedDistribution(UniformDistribution(box), model)
    updater = SMCUpdater(BinomialModel(model), n_particles, prior, seed=seed,
                         device=device)
    expparams = {"m": ms.astype(np.float32),
                 "n_meas": n_shots.astype(np.float32)}
    if interleaved:
        expparams["reference"] = arr[:, 3].astype(np.int32)
    # The counts are survivals (outcome 0 of the two-outcome model);
    # BinomialModel counts outcome-1 events.
    updater.batch_update((n_shots - counts).astype(np.int32), expparams)
    return _result(updater, return_all)
