"""Plain reference of ``simple_precession``: the exact posterior of one
precession frequency ω under a uniform prior on [lo, hi], given a record
of single-shot outcomes with Pr(0 | ω, t) = cos²(ωt/2).

A grid of cells over [lo, hi] carries the log of the posterior's mass in
each cell. Each experiment's likelihood enters as its exact average over
the cell, (1 ± cos(ωt)·sinc(tw/2))/2 at the cell's centre, so a cell wider
than the likelihood's period still integrates it exactly. Before an
experiment, cells wider than 1/``per_period`` of its period are split, and
the log-likelihood of the new cells is computed afresh from every earlier
experiment; cells whose mass lies more than ``cut`` nats below the
largest are dropped first. Splitting stops at ``min_width`` (far below an
f32 ulp of ω) and at ``max_cells``.

Plain PyTorch, on the CPU by default; imports nothing of the system under
test. ``dtype`` is the arithmetic's precision (float64 for the
reference); the cells' bookkeeping stays in float64.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def _log_lik(centre, width, ts, outcomes, dtype):
    """(cells,) sum over the experiments of the log cell-average
    likelihood, in ``dtype``."""
    c = centre.to(dtype)[:, None]
    half = (0.5 * width).to(dtype)[:, None]
    t = ts.to(dtype)[None, :]
    o = outcomes.to(dtype)[None, :]
    avg_cos = torch.cos(c * t) * torch.sinc(half * t / math.pi)
    lik = 0.5 * (1.0 + (1.0 - 2.0 * o) * avg_cos)
    tiny = torch.finfo(dtype).tiny
    return torch.log(torch.clamp(lik, min=tiny)).sum(dim=1)


def posterior(ts, outcomes, lo=0.0, hi=1.0, dtype=F64, per_period=256,
              start_cells=4096, cut=80.0, min_width=2.0 ** -34,
              max_cells=1 << 20, chunk=1 << 16, device="cpu"):
    """The exact posterior's mean, standard deviation and log evidence
    (log of the record's probability under the prior) as floats."""
    times = [float(t) for t in ts]
    ts = torch.as_tensor(ts, dtype=F64, device=device).reshape(-1)
    outcomes = torch.as_tensor(outcomes, dtype=F64,
                               device=device).reshape(-1)
    width = torch.full((start_cells,), (hi - lo) / start_cells, dtype=F64,
                       device=device)
    centre = lo + (torch.arange(start_cells, dtype=F64, device=device)
                   + 0.5) * width
    ll = torch.zeros(start_cells, dtype=dtype, device=device)
    for k in range(ts.numel()):
        need = max(2.0 * math.pi / (per_period * times[k]), min_width)
        if float(width.max()) > need:
            lp = ll.to(F64) + torch.log(width)
            keep = lp >= lp.max() - cut
            centre, width = centre[keep], width[keep]
            split = torch.clamp(torch.ceil(width / need), min=1).long()
            total = int(split.sum())
            if total <= max_cells:
                rep = torch.repeat_interleave(
                    torch.arange(split.numel(), device=device), split,
                    output_size=total)
                first = torch.cumsum(split, 0) - split
                j = torch.arange(total, device=device) - first[rep]
                w_new = (width / split)[rep]
                centre = centre[rep] - 0.5 * width[rep] + (j + 0.5) * w_new
                width = w_new
                ll = torch.cat([
                    _log_lik(centre[i:i + chunk], width[i:i + chunk],
                             ts[:k], outcomes[:k], dtype)
                    for i in range(0, centre.numel(), chunk)])
            else:
                ll = ll[keep]
        ll = ll + _log_lik(centre, width, ts[k:k + 1], outcomes[k:k + 1],
                           dtype)
    lp = ll + torch.log(width).to(dtype)
    log_z = torch.logsumexp(lp, 0)
    p = torch.exp(lp - log_z)
    x = centre.to(dtype)
    mean = torch.sum(p * x)
    var = torch.sum(p * ((x - mean) ** 2 + (width.to(dtype) ** 2) / 12.0))
    return {"mean": float(mean), "sd": float(torch.sqrt(var)),
            "log_evidence": float(log_z) - math.log(hi - lo)}
