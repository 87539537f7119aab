"""What every driver shares: the seed's generators, the device's sync, the
program's counters, the benchmark's spans and a clock for short spans.

A driver (``drivers/<kind>.py``) defines ``Driver(cell, seed, device)``
with ``setup()`` (one warm unit of the cell's own traffic), ``unit(i)``
(one unit of the window; returns its ``work`` and ``steps`` and ends
with the answer on the host), ``counters()``, ``end_to_end()``,
``release()`` and ``check(control)``.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import record_function

from . import inputs


def span(name):
    """A span of the benchmark's own around a call into a layer, seen by
    the profiler in a traced run (``bench.<name>``)."""
    return record_function(f"bench.{name}")


class Base:
    def __init__(self, cell, seed, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.count = collections.Counter()

    def generator(self, *keys):
        return torch.Generator(device=self.device).manual_seed(
            inputs.derive(self.seed, *keys))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self):
        """The driver's counts and the program's own counters (the
        resampler's postselection rounds)."""
        from qinfer_tpu_torch.resamplers import LiuWestResampler

        out = {k: list(v) if isinstance(v, list) else v
               for k, v in self.count.items()}
        out["redraw_rounds"] = LiuWestResampler.redraw_rounds
        return out

    def end_to_end(self):
        return {}

    def release(self):
        pass


class SpanClock:
    """Marks within the steps of one unit and the milliseconds between
    them. On the card each mark is a CUDA event on the current stream, so
    a span is timed by the device's clock from the moment the device
    reached the first mark to the moment it reached the second (the host
    clock is off by about half a millisecond); on the CPU, the host clock."""

    def __init__(self, device, steps, marks):
        self.cuda = torch.device(device).type == "cuda"
        self.steps, self.marks = steps, marks
        if self.cuda:
            self.events = [[torch.cuda.Event(enable_timing=True)
                            for _ in range(marks)] for _ in range(steps)]
        else:
            self.times = [[0.0] * marks for _ in range(steps)]

    def mark(self, step, j):
        if self.cuda:
            self.events[step][j].record()
        else:
            self.times[step][j] = time.perf_counter()

    def ms(self, a, b, steps):
        """Milliseconds from mark ``a`` to mark ``b`` of the first
        ``steps`` steps (after the device has passed them)."""
        if self.cuda:
            return [self.events[s][a].elapsed_time(self.events[s][b])
                    for s in range(steps)]
        return [1e3 * (self.times[s][b] - self.times[s][a])
                for s in range(steps)]
