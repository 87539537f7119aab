"""Throughput meter, device traces and trace annotations. Counterpart of
``qinfer_tpu/profiling.py``.

- ``ThroughputMeter``: particle-updates per second over measured blocks;
  ``sync=`` takes a tensor whose device is synchronised before the clock
  stops (a CUDA call returns before the card has finished).
- ``trace(log_dir)``: ``torch.profiler`` around a block (the CPU, and
  CUDA when torch sees a card), written as a Chrome trace,
  ``<log_dir>/trace.json``.
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``), and an NVTX range when torch sees
  a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["ThroughputMeter", "trace", "annotate"]


class ThroughputMeter:
    """Accumulates particle-updates and wall time, in particles per second::

        meter = ThroughputMeter()
        with meter.measure(n_particles * n_updates,
                           sync=updater.particle_log_weights):
            updater.batch_update(outcomes, expparams)
        meter.particles_per_second
    """

    def __init__(self):
        self.total_particle_updates = 0
        self.total_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_particle_updates, sync=None):
        t0 = time.perf_counter()
        yield self
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.total_seconds += time.perf_counter() - t0
        self.total_particle_updates += int(n_particle_updates)

    @property
    def particles_per_second(self):
        if self.total_seconds == 0:
            return 0.0
        return self.total_particle_updates / self.total_seconds

    def report(self):
        return {"particle_updates": self.total_particle_updates,
                "seconds": self.total_seconds,
                "particle_updates_per_s": self.particles_per_second}


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` around the block; on exit the Chrome trace is
    written to ``<log_dir>/trace.json`` (``log_dir`` is created). Yields
    the profiler (``key_averages()`` and the like)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name):
    """A named range around the block in ``trace``'s timeline, and an NVTX
    range when torch sees a CUDA device."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
