"""Fused Bayes update (kernel B1): wrapper, likelihood tiles, plain version.

Counterpart of ``qinfer_tpu/ops/fused_update.py``. One pass over the bank
computes the likelihood, the log-weight update and both streaming
log-sum-exps (evidence and ESS). On a CUDA tensor ``fused_bayes_update``
launches the hand-written kernel in ``csrc/fused_update.cu`` (its header
says what bounds it and how it is laid out); on a CPU tensor it runs
``fused_update_plain``, the same function in plain PyTorch. A failed build
or launch raises: nothing falls back.

A likelihood tile is ``tile(scalars, *param_cols) -> (N,) log L`` in plain
PyTorch; the kernel runs the tile's CUDA functor, named by ``kernel_tile``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from .. import _build

__all__ = [
    "fused_bayes_update", "fused_update_plain", "two_outcome_tile",
    "precession_pr1",
]

_LOG_TINY = -87.0
_THREADS = 256  # kThreads in csrc/fused_update.cu
_ITEMS_PER_THREAD = 4
_MAX_BLOCKS = 1024


def precession_pr1(scalars, off, omega):
    """SimplePrecession: 1 − cos²(ωt/2); scalars tail = [t]."""
    c = torch.cos(0.5 * omega * scalars[off])
    return 1.0 - c * c


# pr1 function -> index of its CUDA functor in qt_fused_update.
_KERNEL_TILES = {precession_pr1: 0}


@dataclass(frozen=True)
class TwoOutcomeTile:
    """scalars = [outcome, *pr1_scalars]; log(max(pr, 1e-35)) with
    pr = pr1 for outcome 1 and 1 − pr1 otherwise."""

    pr1_fn: Callable

    def __call__(self, scalars, *cols):
        outcome = scalars[0]
        pr1 = self.pr1_fn(scalars, 1, *cols)
        pr = torch.where(outcome == 1.0, pr1, 1.0 - pr1)
        return torch.log(torch.clamp(pr, min=1e-35))

    @property
    def kernel_tile(self):
        return _KERNEL_TILES.get(self.pr1_fn)


def two_outcome_tile(pr1_fn):
    return TwoOutcomeTile(pr1_fn)


def fused_update_plain(tile_fn, scalars, log_w, param_cols):
    """Plain PyTorch version of the kernel: (lw, lse, lse2, ess) with lw
    unnormalized. Runs on any device."""
    log_l = tile_fn(scalars, *param_cols)
    lw = log_w + torch.clamp(log_l, min=_LOG_TINY)
    m = torch.max(lw)
    lse = m + torch.log(torch.sum(torch.exp(lw - m)))
    lw2 = 2.0 * lw
    m2 = torch.max(lw2)
    lse2 = m2 + torch.log(torch.sum(torch.exp(lw2 - m2)))
    ess = torch.exp(-(lse2 - 2.0 * lse))
    return lw, lse, lse2, ess


def _fused_update_cuda(tile_fn, scalars, log_w, param_cols):
    tile = getattr(tile_fn, "kernel_tile", None)
    if tile is None:
        raise NotImplementedError(
            f"no CUDA functor for likelihood tile {tile_fn!r}"
        )
    device = log_w.device
    n = log_w.shape[0]
    if log_w.dtype != torch.float32 or log_w.ndim != 1 or n == 0:
        raise ValueError("log_w must be a non-empty 1-D float32 tensor")
    log_w = log_w.contiguous()
    scalars = scalars.to(device=device, dtype=torch.float32).contiguous()
    cols = [c.to(torch.float32).contiguous() for c in param_cols]
    if any(c.device != device or c.shape != (n,) for c in cols):
        raise ValueError("param_cols must be (N,) tensors on log_w's device")
    n_blocks = max(1, min(_MAX_BLOCKS,
                          -(-n // (_THREADS * _ITEMS_PER_THREAD))))
    out = torch.empty_like(log_w)
    partials = torch.empty(3 * n_blocks, dtype=torch.float32, device=device)
    stats = torch.empty(4, dtype=torch.float32, device=device)
    col_ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    lib, _ = _build.library()
    with torch.cuda.device(device):
        err = lib.qt_fused_update(
            tile, scalars.data_ptr(), log_w.data_ptr(),
            ctypes.cast(col_ptrs, ctypes.c_void_p), len(cols),
            out.data_ptr(), partials.data_ptr(), n_blocks, stats.data_ptr(),
            n, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_fused_update")
    fused_bayes_update.launches += 1
    return out, stats[0], stats[1], stats[3]


def fused_bayes_update(tile_fn, scalars, log_w, param_cols,
                       return_stats=False):
    """One fused SMC update.

    ``scalars``: (k,) f32 on the bank's device (outcome, then the tile's
    expparams); ``log_w``: (N,) normalized log-weights; ``param_cols``:
    tuple of (N,) f32 parameter columns.

    Returns (log_w_normalized, log_norm, ess). ``return_stats=True``
    returns the raw (log_w_unnormalized, lse, lse2) instead, with
    lse = logsumexp(lw) and lse2 = logsumexp(2·lw).
    """
    if log_w.is_cuda:
        lw, lse, lse2, ess = _fused_update_cuda(tile_fn, scalars, log_w,
                                                param_cols)
    else:
        lw, lse, lse2, ess = fused_update_plain(tile_fn, scalars, log_w,
                                                param_cols)
    if return_stats:
        return lw, lse, lse2
    return lw - lse, lse, ess


fused_bayes_update.launches = 0
