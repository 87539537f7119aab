"""The measured window: a closed loop of one user, each unit starting when
the last one ends, until ``seconds`` have passed.

The window runs from its start to the end of the last unit that finished,
and every unit in it counts whole: a rate is all the work of the window
over all its time, never a median of chunks. A unit ends when the user
has the unit's answer on the host, so the clock read after it is the
unit's real end.

With tracing, the profiler covers the units that start within the first
``trace_seconds`` of the window (the traced stretch); the rest of the
window runs untraced. The driver's counters over the stretch go into the
trace's summary.
"""

from __future__ import annotations

import dataclasses
import time

from .trace import Tracer


@dataclasses.dataclass
class Window:
    seconds: float  # start to the end of the last unit
    units: int
    work: float  # particle updates of the window's units, summed
    steps: int
    trace: dict | None  # the traced stretch's summary


def _delta(after, before):
    out = {}
    for k, v in after.items():
        if isinstance(v, (int, float)):
            out[k] = v - before.get(k, 0)
        else:  # a list of the stretch's samples
            out[k] = list(v)[len(before.get(k, ())):]
    return out


def run(driver, seconds, trace_seconds=None, device="cuda"):
    """Runs ``driver.unit(i)`` for i = 0, 1, … until ``seconds`` have
    passed. Returns a ``Window``."""
    tracer = Tracer(device) if trace_seconds else None
    before = driver.counters()
    if tracer is not None:
        tracer.start()
    driver.sync()
    t0 = time.perf_counter()
    units = steps = 0
    work = 0.0
    trace = None
    while True:
        done = driver.unit(units)
        units += 1
        work += done["work"]
        steps += done["steps"]
        elapsed = time.perf_counter() - t0
        if tracer is not None and elapsed >= trace_seconds:
            trace = tracer.stop(elapsed, _delta(driver.counters(), before))
            tracer = None
        if elapsed >= seconds:
            break
    seconds_ = time.perf_counter() - t0
    if tracer is not None:  # the window ended inside the traced stretch
        trace = tracer.stop(seconds_, _delta(driver.counters(), before))
    return Window(seconds_, units, work, steps, trace)
