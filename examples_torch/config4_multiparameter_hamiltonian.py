"""BASELINE config 4: multi-parameter Hamiltonian learning — MultiCosModel
(2 frequencies) and known-T2 precession. Twin of
examples/config4_multiparameter_hamiltonian.py on qinfer_tpu_torch: the
evolution times are drawn with NumPy as there, the outcomes on the
updater's device; ``--cpu`` runs it on the CPU."""

import sys

import numpy as np
import torch

import qinfer_tpu_torch as qt


def multicos(seed=0, n_exp=150, device="cuda"):
    model = qt.MultiCosModel(n_terms=2)
    prior = qt.UniformDistribution([[0.0, 1.0], [0.0, 1.0]])
    u = qt.SMCUpdater(model, 8000, prior, seed=seed, device=device)
    true = torch.tensor([[0.35, 0.75]], device=u.device)
    sim = torch.Generator(device=u.device).manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    for k in range(n_exp):
        # Random two-axis evolution times (exp-sparse magnitude).
        scale = min((9 / 8) ** (k // 2), 300.0)
        ts = scale * rng.dirichlet([1.0, 1.0])
        ep = {"ts": torch.tensor(ts, dtype=torch.float32,
                                 device=u.device)[None, :]}
        out = model.simulate_experiment(sim, true, ep)[0, 0, 0]
        u.update(out, ep)
    est = np.sort(u.est_mean().cpu().numpy())
    print(f"MultiCos: true {true.cpu().numpy()[0]}, est {est}")
    return u


def known_t2(seed=0, n_exp=100, t2=100.0, device="cuda"):
    model = qt.KnownT2PrecessionModel(t2=t2)
    prior = qt.UniformDistribution([0.0, 1.0])
    u = qt.SMCUpdater(model, 5000, prior, seed=seed, device=device)
    true = torch.tensor([[0.44]], device=u.device)
    heuristic = qt.PGH(u)
    sim = torch.Generator(device=u.device).manual_seed(seed + 2)
    for _ in range(n_exp):
        ep = heuristic()
        out = model.simulate_experiment(sim, true, ep)[0, 0, 0]
        u.update(out, ep)
    est = float(u.est_mean()[0])
    std = float(torch.sqrt(u.est_covariance_mtx()[0, 0]))
    print(f"known-T2: true 0.44, est {qt.utils.format_uncertainty(est, std)}")
    assert abs(est - 0.44) < 6 * std + 5e-3
    return u


if __name__ == "__main__":
    _device = "cpu" if "--cpu" in sys.argv else "cuda"
    known_t2(device=_device)
    multicos(device=_device)
