"""BASELINE config 1: SimplePrecessionModel frequency estimation,
5000 particles, Liu–West resampler, adaptive PGH (the qinfer docs
quickstart). Twin of examples/config1_precession_quickstart.py on
qinfer_tpu_torch; ``--cpu`` runs it on the CPU."""

import sys

import torch

import qinfer_tpu_torch as qt


def main(true_omega=0.512, n_exp=100, seed=0, device="cuda"):
    model = qt.SimplePrecessionModel()
    prior = qt.UniformDistribution([0.0, 1.0])
    updater = qt.SMCUpdater(model, 5000, prior, seed=seed, device=device)
    heuristic = qt.PGH(updater)

    sim = torch.Generator(device=updater.device).manual_seed(seed + 1)
    truth = torch.tensor([[true_omega]], device=updater.device)
    for _ in range(n_exp):
        expparams = heuristic()
        outcome = model.simulate_experiment(sim, truth, expparams)[0, 0, 0]
        updater.update(outcome, expparams)

    est = float(updater.est_mean()[0])
    std = float(torch.sqrt(updater.est_covariance_mtx()[0, 0]))
    print(f"true ω = {true_omega}")
    print(f"est  ω = {qt.utils.format_uncertainty(est, std)}")
    print(f"resamples: {updater.resample_count}, "
          f"log evidence: {updater.log_total_likelihood:.2f}")
    assert abs(est - true_omega) < 6 * std + 1e-3
    return updater


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else "cuda")
