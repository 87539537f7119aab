"""Throughput meter, device traces, and the program's spans and counters.
Counterpart of ``qinfer_tpu/profiling.py``.

- ``ThroughputMeter``: particle-updates per second over measured blocks;
  ``sync=`` takes a tensor whose device is synchronised before the clock
  stops (a CUDA call returns before the card has finished).
- ``trace(log_dir)``: ``torch.profiler`` around a block (the CPU, and
  CUDA when torch sees a card), written as a Chrome trace,
  ``<log_dir>/trace.json``.
- ``span(name)``: a named block of the program, recorded only while a
  torch profiler records. It is then a host range in the profiler's trace,
  on the clock of its device events (a function-scope record, which the
  trace does not mirror on the device as it does ``record_function``'s
  user scopes), and it adds to the stretch's aggregates of its name: the
  calls, their total and self nanoseconds (self: the duration less that of
  the spans opened inside it) and the names of the spans that opened it
  (its parents). With no profiler it costs one check and does nothing. A
  span opened inside a span of the same name is folded into it.
  ``annotate(name)`` is the same span, for a user's own blocks.
- ``count(name, n)``: adds to one of the program's counters while a
  profiler records, and returns at once otherwise. ``counters()`` reads
  them under dotted names: ``smc.steps`` (one a step call), the kernel
  wrappers' launches (``ops.<wrapper>.launches``, by route
  ``ops.<wrapper>.<route>_launches``, by form
  ``ops.<wrapper>.form_launches.<form>``), the rows that the validity
  kernels tested (``ops.psd_valid.rows``: the test's and the redraw
  round's), ``resamplers.LiuWestResampler.redraw_rounds``,
  ``resamplers.LiuWestResampler.kernel_rounds`` (the redraw rounds that
  took the model's one-launch round),
  ``resamplers.LiuWestResampler.unfused_batched`` (the batched resamples
  that did not take ``ops.liu_west_expand_batched``),
  ``resamplers.LiuWestResampler.tested_rows`` (the rows put through a
  validity test, from their shapes, and for a one-launch round the rows
  still invalid that the host read before it),
  ``resamplers.LiuWestResampler.clamped_rows`` (the rows that
  postselection projected with ``canonicalize``),
  ``resamplers.LiuWestResampler.clamped_resamples`` (the resamples whose
  redraw rounds ran out with rows still invalid, so that the clamp ran),
  ``ops.<wrapper>.wide_launches`` (kernel B1's launches of more than 16
  columns) and ``ops.<wrapper>.unfused_wide`` (the updates of a bank on
  CUDA that took the unfused route because their functor's tile has more
  than ``MAX_COLS`` columns). The wrappers' and the resampler's attributes
  of the same names count always.
- ``recorded()``: the aggregates of the last stretch in which a profiler
  recorded, and the increase of each counter that grew over it. A
  stretch starts at the first span that sees a profiler recording after
  one that saw none, and ends at the first span (or call of
  ``recorded``) that sees none; so two profilers with no call of the
  program between them make one stretch.

The program's spans are named ``qinfer.<layer>.<block>``: the SMC step
and its Bayes update (``qinfer.smc.*``), kernel B1's and B2's wrappers
(``qinfer.ops.b1``, ``qinfer.ops.b2``), the Liu–West resample
(``qinfer.resamplers.*``, with its validity tests
``qinfer.resamplers.valid`` and its clamp ``qinfer.resamplers.clamp``),
each blocking read that the program makes on purpose (``qinfer.sync.*``),
and the trial loop of ``perf_testing`` with the design heuristics
(``qinfer.perf_testing.*``, ``qinfer.design.*``).

The spans are kept for one thread: the program steps from one.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

__all__ = ["ThroughputMeter", "trace", "annotate", "span", "count",
           "counters", "recorded"]

_profiling = torch.autograd._profiler_enabled
_HostRange = torch._C._profiler._RecordFunctionFast


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


class _Stretch:
    """One stretch in which a profiler recorded: the spans' aggregates by
    name and the counters at its start (and at its end, once it ended)."""

    def __init__(self):
        self.spans = {}
        self.start = counters()
        self.end = None


class _Aggregate:
    __slots__ = ("count", "total_ns", "self_ns", "parents")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.parents = collections.Counter()


class _Null:
    """The span of a block that nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()
_open = []  # the spans open now, innermost last
_last = None  # the last stretch (None before the first)
_live = False  # whether ``_last`` is still recording
_counts = collections.Counter()  # the program's counters


class _Span:
    __slots__ = ("name", "stretch", "parent", "child_ns", "t0", "_range")

    def __init__(self, name, stretch):
        self.name = name
        self.stretch = stretch
        self._range = _HostRange(name)

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self)
        self.child_ns = 0
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        dt = t1 - self.t0
        _open.pop()
        agg = self.stretch.spans.get(self.name)
        if agg is None:
            agg = self.stretch.spans[self.name] = _Aggregate()
        agg.count += 1
        agg.total_ns += dt
        agg.self_ns += dt - self.child_ns
        if self.parent is None:
            agg.parents[None] += 1
        else:
            self.parent.child_ns += dt
            agg.parents[self.parent.name] += 1
        return False


def _end():
    global _live
    _last.end = counters()
    _live = False


def span(name):
    """A context manager around a block named ``name``: a host range in the
    trace and an entry in ``recorded()`` while a torch profiler records,
    nothing otherwise (module docstring)."""
    global _last, _live
    if not _profiling():
        if _live:
            _end()
        return _NULL
    if not _live:
        _last = _Stretch()
        _live = True
    if _open and _open[-1].name == name:
        return _NULL
    return _Span(name, _last)


def annotate(name):
    """A named range around a user's block in ``trace``'s timeline: the
    program's ``span``, so it is recorded only while a profiler records and
    appears in ``recorded()`` beside the program's own spans."""
    return span(name)


def count(name, n=1):
    """Adds ``n`` to the program's counter ``name`` while a torch profiler
    records; does nothing otherwise."""
    if _live and _profiling():
        _counts[name] += n


def counters():
    """The program's counters as they stand, under dotted names (module
    docstring)."""
    return dict(_counts)


def recorded():
    """The last stretch in which a torch profiler recorded (module
    docstring): ``{"spans": {name: {"count", "total_ns", "self_ns",
    "parents": {parent name or None: calls}}}, "counters": {name:
    increase}}`` with the counters that increased in the stretch; empty
    before any stretch."""
    if _live and not _profiling():
        _end()
    if _last is None:
        return {"spans": {}, "counters": {}}
    now = _last.end if _last.end is not None else counters()
    return {
        "spans": {name: {"count": a.count, "total_ns": a.total_ns,
                         "self_ns": a.self_ns, "parents": dict(a.parents)}
                  for name, a in _last.spans.items()},
        "counters": {k: v - _last.start.get(k, 0) for k, v in now.items()
                     if v > _last.start.get(k, 0)},
    }
