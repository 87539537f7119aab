"""Optimal experiment design on torch tensors.

Counterpart of ``qinfer_tpu/expdesign.py``: ``ExperimentDesigner``
(``design_expparams_field`` minimizing cost·k + Bayes risk over one
expparams field with scipy.optimize) and ``OptimizationAlgorithms``. The
objective's gradient is exact: ``torch.autograd`` differentiates
``bayes_risk_fn`` (plain torch over the bank, no kernel) where the JAX
package uses ``jax.value_and_grad``. The bank stays on the updater's
device; each evaluation reads back one value and one gradient.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from .smc import _expparams_to, bayes_risk_fn

__all__ = ["ExperimentDesigner", "OptimizationAlgorithms"]


class OptimizationAlgorithms(enum.Enum):
    """scipy.optimize methods; CG and NCG are the documented choices."""

    CG = "CG"
    NCG = "Newton-CG"
    NELDER_MEAD = "Nelder-Mead"


class ExperimentDesigner:
    """Locally optimizes experiment parameters against Bayes risk.
    ``new_exp()`` clears the stored-guess history;
    ``design_expparams_field`` optimizes one field of the expparams. The
    device is the updater's."""

    def __init__(self, updater, opt_algo=OptimizationAlgorithms.CG):
        self._updater = updater
        self._opt_algo = (
            opt_algo
            if isinstance(opt_algo, OptimizationAlgorithms)
            else OptimizationAlgorithms(opt_algo)
        )
        self._best_cost = None
        self._guesses = []

    def new_exp(self):
        """Forget the stored guesses."""
        self._best_cost = None
        self._guesses = []

    def _value_and_grad(self, x, ep_rest, outcomes, field, field_shape,
                        cost_scale_k, cost_mult):
        """(objective, d objective / d field) at the flat f32 field ``x``."""
        model = self._updater.model
        x = x.detach().requires_grad_(True)
        ep = dict(ep_rest)
        ep[field] = x.reshape(field_shape)
        risk = bayes_risk_fn(model, self._updater.state, ep, model.Q,
                             outcomes=outcomes)[0]
        cost = model.experiment_cost(ep)[0]
        if cost_mult:
            value = risk * (1.0 + cost_scale_k * (cost - 1.0))
        else:
            value = risk + cost_scale_k * (cost - 1.0)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    def design_expparams_field(self, guess, field, cost_scale_k=1.0,
                               disp=False, maxiter: Optional[int] = None,
                               maxfun: Optional[int] = None,
                               store_guess=False, grad_h=None,
                               cost_mult=False, project=None):
        """Optimize ``field`` of the guessed expparams against Bayes risk.

        ``guess``: an expparams dict (fields of length 1), a Heuristic, or
        a heuristic class to draw the starting point from. The field may be
        a scalar (shape (1,)) or a vector (shape (1, K)). ``project`` maps a
        flat float64 candidate onto the feasible set; it is applied to the
        guess and to every evaluation. ``grad_h`` is accepted for API
        parity (the gradient is exact). The guess is kept when the
        optimizer does not improve on it.
        """
        import scipy.optimize

        del grad_h
        from .heuristics import Heuristic

        if isinstance(guess, dict):
            ep_guess = guess
        elif isinstance(guess, Heuristic):
            ep_guess = guess()
        elif callable(guess):
            ep_guess = guess(self._updater)()
        else:
            raise TypeError(
                "guess must be an expparams dict, a Heuristic, or a "
                "heuristic class."
            )
        device = self._updater.device
        ep_guess = {k: torch.atleast_1d(v) for k, v in
                    _expparams_to(ep_guess, device).items()}
        # Outcomes are enumerated once (BinomialModel counts from n_meas).
        outcomes = self._updater.model.all_outcomes(ep_guess)
        ep_rest = {k: v for k, v in ep_guess.items() if k != field}
        field_arr = ep_guess[field].cpu().numpy().astype(np.float64)
        field_shape = ((1,) if field_arr.ndim <= 1
                       else (1,) + field_arr.shape[1:])
        x0 = field_arr.reshape(-1)
        if project is not None:
            x0 = np.asarray(project(x0), dtype=np.float64).reshape(-1)

        def f(x):
            if project is not None:
                x = np.asarray(project(x), dtype=np.float64).reshape(-1)
            val, grad = self._value_and_grad(
                torch.as_tensor(x, dtype=torch.float32, device=device),
                ep_rest, outcomes, field, field_shape, float(cost_scale_k),
                bool(cost_mult))
            return float(val), grad.cpu().numpy().astype(np.float64)

        # The first evaluation is at x0: keep it to compare the result with.
        first = {}

        def f_first(x):
            out = f(x)
            first.setdefault("f0", out[0])
            return out

        options = {}
        if maxiter is not None:
            options["maxiter"] = int(maxiter)
        if maxfun is not None:
            if self._opt_algo == OptimizationAlgorithms.NELDER_MEAD:
                options["maxfev"] = int(maxfun)
            else:
                # CG/NCG have no separate evaluation budget: honor the
                # tighter of the two bounds.
                options["maxiter"] = (min(int(maxiter), int(maxfun))
                                      if maxiter is not None
                                      else int(maxfun))

        if self._opt_algo == OptimizationAlgorithms.NELDER_MEAD:
            res = scipy.optimize.minimize(
                lambda x: f_first(x)[0], x0, method="Nelder-Mead",
                options=options)
        else:
            res = scipy.optimize.minimize(
                f_first, x0, jac=True, method=self._opt_algo.value,
                options=options)
        if disp:
            print(res)

        x_best = np.asarray(res.x, dtype=np.float64).reshape(-1)
        cost_best = float(res.fun)
        if project is not None:
            # The optimizer scored project(x) at every evaluation, so
            # res.fun already is the cost of the projected point.
            x_best = np.asarray(project(x_best), dtype=np.float64).reshape(-1)
        f0 = first["f0"]
        if not np.isfinite(cost_best) or cost_best > f0:
            x_best, cost_best = x0, f0

        if store_guess:
            self._guesses.append((cost_best, x_best))
            if self._best_cost is None or cost_best < self._best_cost:
                self._best_cost = cost_best
            else:
                x_best = min(self._guesses, key=lambda g: g[0])[1]

        out = dict(ep_rest)
        out[field] = torch.as_tensor(x_best.reshape(field_shape),
                                     dtype=torch.float32, device=device)
        return out
