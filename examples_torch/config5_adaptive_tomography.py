"""BASELINE config 5: qubit state tomography over Pauli bases with
adaptive EIG-driven measurement choice (+ PGH-style posterior sampling).
Twin of examples/config5_adaptive_tomography.py on qinfer_tpu_torch.

    python -m examples_torch.config5_adaptive_tomography [--cpu]
    python -m examples_torch.config5_adaptive_tomography --sharded [--cpu K]

``--sharded`` runs ``main_sharded`` on one rank a card (NCCL), or on K
gloo ranks of the CPU with ``--cpu K``, each rank a process of its own
(``qinfer_tpu_torch.parallel.launch``).
"""

import argparse
import sys

import numpy as np
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.parallel import launch
from qinfer_tpu_torch.tomography import (
    GinibreDistribution,
    TomographyModel,
    pauli_basis,
)

MODULE = "examples_torch.config5_adaptive_tomography"


def _truth_and_effects(basis):
    """The true state (slightly mixed |+⟩) and the candidate effects
    (projectors onto X/Y/Z eigenstates), in the basis's coordinates."""
    true_rho = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = basis.state_to_modelparams(true_rho[None])[0].numpy()
    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = [
        basis.state_to_modelparams(P.astype(np.complex64)[None])[0].numpy()
        for P in projs
    ]
    return true_rho, true_x, effects


def main(seed=0, n_exp=80, device="cuda"):
    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    u = qt.SMCUpdater(model, 4000, prior, seed=seed, device=device)
    true_rho, true_x, effects = _truth_and_effects(basis)
    cand = {"meas": torch.as_tensor(np.stack(effects), device=u.device)}

    sim = torch.Generator(device=u.device).manual_seed(seed + 1)
    for _ in range(n_exp):
        ig = u.expected_information_gain(cand).cpu().numpy()
        k = int(np.argmax(ig))
        pr1 = float(np.clip(true_x @ effects[k], 0, 1))
        outcome = int(torch.rand((), generator=sim, device=u.device) < pr1)
        u.update(outcome, {"meas": cand["meas"][k:k + 1]})

    est_x = u.est_mean().cpu().numpy()
    err = np.linalg.norm(est_x - true_x)
    print(f"coordinate error ‖x̂ − x‖ = {err:.4f}, "
          f"resamples = {u.resample_count}")
    est_rho = basis.modelparams_to_state(est_x)
    fid_proxy = float(np.real(np.trace(est_rho @ true_rho)))
    print(f"Tr(ρ̂ ρ) = {fid_proxy:.4f}")
    assert bool(model.are_models_valid(torch.as_tensor(est_x[None]))[0])
    return u


def main_sharded(seed=0, n_exp=160, n_devices=None, device="cuda"):
    """The same adaptive loop against a bank SHARDED over the ranks of the
    process group that the caller started (every rank calls this):
    ``make_sharded_greedy_propose`` scores the EIG of every candidate
    with all-reduced streaming statistics, the outcome is simulated on
    the device from the true state, and ``make_sharded_update_step``
    advances the sharded posterior (distributed systematic resampling
    included), all through ``make_sharded_adaptive_episode``. 512
    particles a rank; ``device`` is this rank's (its card, or the CPU).
    Returns the rank's final state and the errors of the first and last
    steps' estimates."""
    from qinfer_tpu_torch.parallel import (
        make_particle_mesh,
        make_sharded_adaptive_episode,
        make_sharded_greedy_propose,
        shard_state,
    )
    from qinfer_tpu_torch.smc import SMCConfig, init_smc_state

    device = torch.device(device)
    mesh = make_particle_mesh(n_devices, device_type=device.type)
    n_devices = mesh.size()

    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    n_particles = 512 * n_devices
    state = shard_state(
        init_smc_state(torch.Generator(device=device).manual_seed(seed),
                       model, n_particles, prior),
        mesh,
    )
    resampler = qt.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")
    _, true_x, effects = _truth_and_effects(basis)
    cand = {"meas": torch.as_tensor(np.stack(effects))}

    propose = make_sharded_greedy_propose(mesh, model, cand, use_eig=True)
    episode = make_sharded_adaptive_episode(
        mesh, model, resampler, config, propose, true_x, n_exp
    )
    state, records = episode(
        state, torch.Generator(device=device).manual_seed(seed + 1))
    mean_traj = records["est_mean"].cpu().numpy()
    err0 = float(np.linalg.norm(mean_traj[0] - true_x))
    err = float(np.linalg.norm(mean_traj[-1] - true_x))
    print(f"[sharded x{n_devices}] episode ({n_exp} exps): "
          f"first-step err {err0:.4f} → last-step err {err:.4f}, "
          f"resamples = {int(state.n_resamples)}")
    assert err < 0.2 and err < err0 / 3
    return state, err0, err


def _rank(args):
    """One rank of ``--sharded``: ``main_sharded`` on its card or the CPU."""
    cpu = args.cpu > 0
    device = torch.device("cpu") if cpu else torch.device("cuda", args.rank)
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    with launch.process_group(args.dir, args.rank, args.world,
                              "gloo" if cpu else "nccl",
                              timeout_s=60 if cpu else 300):
        kw = {} if args.n_exp is None else {"n_exp": args.n_exp}
        state, err0, err = main_sharded(device=device, **kw)
    launch.write_result(args.dir, args.rank, {
        "rank": args.rank, "world_size": args.world, "err0": err0,
        "err": err, "resamples": int(state.n_resamples)})


def run_sharded(world, cpu=0, n_exp=None, wall_s=launch.WALL_S):
    """``main_sharded`` on ``world`` ranks, a process each (``cpu`` > 0:
    gloo on the CPU, else NCCL, a card a rank). Returns the
    ``launch.RankRun``; run from the repo's root."""
    argv = ["-m", MODULE, "--sharded", "--cpu", str(cpu)]
    if n_exp is not None:
        argv += ["--n-exp", str(n_exp)]
    return launch.run_ranks(argv, world, wall_s)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="main_sharded on one rank a card (or K CPU ranks)")
    ap.add_argument("--cpu", type=int, nargs="?", const=1, default=0,
                    help="on the CPU (with --sharded: this many gloo ranks)")
    ap.add_argument("--n-exp", type=int, default=None)
    launch.add_rank_arguments(ap)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args)
    elif args.sharded:
        world = args.cpu or torch.cuda.device_count()
        run = run_sharded(world, args.cpu, args.n_exp)
        for result in run.results:
            print(result)
        if not run.ok:
            print(run.failure(), file=sys.stderr)
            sys.exit(1)
    else:
        main(device="cpu" if args.cpu else "cuda")
