"""Rebit-plane plots on the host (matplotlib, imported when called).
Counterpart of ``qinfer_tpu/tomography/plotting_tools.py``: particle
clouds of a rebit in the (X, Z) plane of the Bloch disc ([unverified]
names against upstream qinfer, as in the JAX package)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_decorate_rebits", "plot_rebit_prior",
           "plot_rebit_posterior", "rebit_coords"]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rebit_coords(modelparams, rebit_axes=(1, 3)):
    """Basis coordinates → Bloch-plane coordinates (√2·x_i on the chosen
    axes)."""
    return np.sqrt(2.0) * _host(modelparams)[:, list(rebit_axes)]


def plot_decorate_rebits(basis=None, rebit_axes=(1, 3), ax=None):
    """Draw the unit-disc boundary of the rebit state space."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    theta = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(theta), np.sin(theta), "k-", lw=1)
    ax.set_aspect("equal")
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    if basis is not None:
        ax.set_xlabel(basis.labels[rebit_axes[0]])
        ax.set_ylabel(basis.labels[rebit_axes[1]])
    return ax


def plot_rebit_prior(prior, generator=None, n_samples=2000, rebit_axes=(1, 3),
                     ax=None, **plot_args):
    """Scatter ``n_samples`` draws of a rebit prior (from ``generator``, a
    CPU generator seeded 0 when None) inside the Bloch disc."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    xy = rebit_coords(prior.sample(generator, n_samples), rebit_axes)
    ax = plot_decorate_rebits(getattr(prior, "basis", None), rebit_axes, ax)
    ax.scatter(xy[:, 0], xy[:, 1], s=2, alpha=0.3, **plot_args)
    return ax


def plot_rebit_posterior(updater, true_state=None, rebit_axes=(1, 3),
                         ax=None, level=0.95, **plot_args):
    """The posterior cloud coloured by weight, its mean (and the true
    state) in the rebit plane."""
    del level
    xy = rebit_coords(updater.particle_locations, rebit_axes)
    ax = plot_decorate_rebits(getattr(updater.model, "basis", None),
                              rebit_axes, ax)
    ax.scatter(xy[:, 0], xy[:, 1], s=4, c=_host(updater.particle_weights),
               cmap="viridis", alpha=0.5, **plot_args)
    mean_xy = rebit_coords(_host(updater.est_mean())[None, :], rebit_axes)
    ax.plot(mean_xy[0, 0], mean_xy[0, 1], "r*", ms=12, label="est")
    if true_state is not None:
        txy = rebit_coords(_host(true_state).reshape(1, -1), rebit_axes)
        ax.plot(txy[0, 0], txy[0, 1], "kx", ms=10, label="true")
    ax.legend(loc="upper right", fontsize=8)
    return ax
