"""Finite differences. Counterpart of ``qinfer_tpu/finite_difference.py``:
``FiniteDifference``, central differences of a scalar function of
``n_args`` arguments, on the host in f64."""

from __future__ import annotations

import numpy as np

__all__ = ["FiniteDifference"]


class FiniteDifference:
    """Central-difference gradient of ``func`` with step ``h`` (a scalar or
    one step per argument); calling it at ``xs`` gives the gradient."""

    def __init__(self, func, n_args, h=1e-5):
        self.func = func
        self.n_args = int(n_args)
        self.h = np.broadcast_to(np.asarray(h, dtype=float), (self.n_args,))

    def central(self, xs):
        xs = np.asarray(xs, dtype=float).reshape(-1)
        grad = np.zeros(self.n_args)
        for i in range(self.n_args):
            dx = np.zeros(self.n_args)
            dx[i] = self.h[i] / 2.0
            grad[i] = (self.func(*(xs + dx))
                       - self.func(*(xs - dx))) / self.h[i]
        return grad

    __call__ = central
