"""BASELINE config 2: BinomialModel-wrapped precession estimation with
batched two-outcome likelihoods, via the one-call API. Twin of
examples/config2_binomial_estimation.py on qinfer_tpu_torch: the record
is drawn with NumPy as there; ``--cpu`` runs it on the CPU."""

import sys

import numpy as np

import qinfer_tpu_torch as qt


def main(true_omega=0.62, n_shots=40, n_exp=25, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    ts = (9 / 8) ** np.arange(n_exp)
    p1 = 1 - np.cos(0.5 * true_omega * ts) ** 2
    counts = rng.binomial(n_shots, p1)
    data = np.stack([counts, ts, np.full(n_exp, n_shots)], axis=1)

    mean, cov, extra = qt.simple_est_prec(data, return_all=True, seed=seed,
                                          device=device)
    print(f"true ω = {true_omega}")
    print(f"est  ω = {qt.utils.format_uncertainty(float(mean[0]), float(np.sqrt(cov[0, 0])))}")
    assert abs(mean[0] - true_omega) < 6 * np.sqrt(cov[0, 0]) + 1e-3
    return extra["updater"]


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else "cuda")
