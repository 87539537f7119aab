"""Faults planted in the program under test, for the tests that see
``correct`` come out false: each is a list of (object, attribute,
replacement) patches of ``qinfer_tpu_torch``.

- ``unchanged_step``: every update step returns its state unchanged;
- ``half_batch``: the batched step updates the first half of the trials
  only and leaves the rest as they were;
- ``altered_answer``: the answer is altered where the program makes it
  (the posterior's particles after a record, the information gain, an
  ensemble's estimates);
- ``wrong_rows``: the resample's systematic pick (kernel B2 on the card,
  its plain version on the CPU) takes its rows by equal weights, not by
  the bank's;
- ``broken_smear``: the resample's smear is twice as wide (the square root
  of the covariance doubled).
"""

from __future__ import annotations

import dataclasses

import torch


def _unchanged_step():
    from qinfer_tpu_torch import perf_testing, smc

    def step(model, resampler, config, state, outcome, expparams):
        return state, torch.zeros((), device=state.particle_log_weights.device)

    def step_batched(model, resampler, config, state, outcomes, expparams,
                     u0=None):
        lw = state.particle_log_weights
        return state, torch.zeros(lw.shape[0], device=lw.device)

    return [(smc, "smc_update_step", step),
            (perf_testing, "smc_update_step_batched", step_batched)]


def _rows(state, rows):
    """The state of the trials ``rows`` (a slice) of a batched state."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[rows]
        for f in dataclasses.fields(state) if f.name != "generator"})


def _half_batch():
    from qinfer_tpu_torch import perf_testing

    real = perf_testing.smc_update_step_batched

    def step_batched(model, resampler, config, state, outcomes, expparams,
                     u0=None):
        h = state.particle_log_weights.shape[0] // 2
        head = slice(0, h)
        new, log_norm = real(model, resampler, config, _rows(state, head),
                             outcomes[head],
                             {k: v[head] for k, v in expparams.items()})
        out = dataclasses.replace(new, **{
            f.name: torch.cat([getattr(new, f.name),
                               getattr(state, f.name)[h:]])
            for f in dataclasses.fields(state) if f.name != "generator"})
        return out, torch.cat([log_norm, torch.zeros_like(log_norm)])

    return [(perf_testing, "smc_update_step_batched", step_batched)]


def _altered_answer():
    from qinfer_tpu_torch import perf_testing, smc

    batch = smc.smc_batch_update
    eig = smc.expected_information_gain_fn
    to_structured = perf_testing._records_to_structured

    def batch_update(model, resampler, config, state, outcomes, expparams):
        state, log_norms = batch(model, resampler, config, state, outcomes,
                                 expparams)
        return dataclasses.replace(
            state, particle_locations=state.particle_locations + 0.01), \
            log_norms

    def information_gain(*a, **kw):
        return eig(*a, **kw) + 0.01

    def structured(recs, n_trials, n_exp):
        out = to_structured(recs, n_trials, n_exp)
        out["est"] += 0.01
        return out

    return [(smc, "smc_batch_update", batch_update),
            (smc, "expected_information_gain_fn", information_gain),
            (perf_testing, "_records_to_structured", structured)]


def _wrong_rows():
    from qinfer_tpu_torch import resamplers

    expand = resamplers.systematic_expand
    indices = resamplers.systematic_resample_indices

    def equal(log_w):
        return torch.zeros_like(log_w)

    def systematic_expand(log_w, *a, **kw):
        return expand(equal(log_w), *a, **kw)

    def systematic_resample_indices(log_w, *a, **kw):
        return indices(equal(log_w), *a, **kw)

    return [(resamplers, "systematic_expand", systematic_expand),
            (resamplers, "systematic_resample_indices",
             systematic_resample_indices)]


def _broken_smear():
    from qinfer_tpu_torch import resamplers

    sqrtm = resamplers.sqrtm_psd

    def sqrtm_psd(m, *a, **kw):
        return 2.0 * sqrtm(m, *a, **kw)

    return [(resamplers, "sqrtm_psd", sqrtm_psd)]


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer, "wrong_rows": _wrong_rows,
          "broken_smear": _broken_smear}


def patches(name):
    return FAULTS[name]()

