"""The traced stretch of a ``--trace 1`` run, reduced to numbers.

``Tracer`` wraps ``torch.profiler`` (CPU and CUDA activities). ``summary``
turns its events into a JSON-able dict that the per-layer metric readers
take (one per rank):

- ``busy_s``: the union of the device's intervals (kernels, copies,
  sets), as the repository's profiling script's ``device_busy`` computes
  it (frozen here), leaving out the annotations that the trace mirrors on
  the device (the benchmark's spans, the collectives' ``nccl:*``);
- ``device_us``: device microseconds and ``device_count`` calls by
  operation name;
- ``host_calls``: the CUDA runtime and driver calls by name (launches,
  copies, synchronizations);
- ``device_ops`` and ``idle_gaps`` for the result's ``breakdown``: the
  device operations that took most time, and the device's idle gaps by
  what the host was doing (the benchmark's own span and the innermost
  host operation at the gap's middle).
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .stats import merged as merge

SPAN_PREFIX = "bench."
# Host spans that the trace mirrors on the device: the benchmark's own and
# the collectives' (``nccl:all_reduce``, ``c10d::allreduce_``).
MIRRORED = (SPAN_PREFIX, "nccl:", "c10d::")
TOP = 10
NAME_CHARS = 120


class Tracer:
    """A profiler over a stretch of the window: ``start()``, then
    ``stop(window_s, counters)`` returns the stretch's summary."""

    def __init__(self, device):
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self):
        self._prof.start()

    def stop(self, window_s, counters):
        self._prof.stop()
        return summary(self._prof.profiler.kineto_results.events(), window_s,
                       counters)


def _label(starts, ends, names, mids):
    """For each time in ``mids``: the name of the innermost event that
    contains it (the latest-starting one), or None."""
    idx = np.searchsorted(starts, mids, side="right") - 1
    out = []
    for m, i in zip(mids, idx):
        found = None
        for j in range(i, max(i - 256, -1), -1):
            if ends[j] >= m:
                found = names[j]
                break
        out.append(found)
    return out


def _sorted_arrays(events):
    events.sort()
    if not events:
        return np.zeros(0), np.zeros(0), []
    s, e, n = zip(*events)
    return np.asarray(s, np.int64), np.asarray(e, np.int64), list(n)


def summary(events, window_s, counters):
    device, host, spans = [], [], []
    device_us = collections.Counter()
    device_count = collections.Counter()
    host_calls = collections.Counter()
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == cuda:
            if name.startswith(MIRRORED):
                continue
            device.append((start, end))
            device_us[name] += (end - start) / 1e3
            device_count[name] += 1
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name))
        else:
            host.append((start, end, name))
            if name.startswith("cu"):
                host_calls[name] += 1

    merged = merge(device)
    busy_ns = sum(b - a for a, b in merged)

    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(merged, merged[1:])
            if b0 > a1]
    gap_time = collections.Counter()
    if gaps:
        mids = np.asarray([(a + b) // 2 for a, b in gaps], np.int64)
        h_s, h_e, h_n = _sorted_arrays(host)
        s_s, s_e, s_n = _sorted_arrays(spans)
        ops = _label(h_s, h_e, h_n, mids) if h_n else [None] * len(gaps)
        outer = _label(s_s, s_e, s_n, mids) if s_n else [None] * len(gaps)
        for (a, b), op, span in zip(gaps, ops, outer):
            label = f"{span or 'no span'} > {op or 'no host op'}"
            gap_time[label[:NAME_CHARS]] += (b - a) / 1e9

    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "device_us": dict(device_us),
        "device_count": dict(device_count),
        "host_calls": dict(host_calls),
        "counters": counters,
        "device_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in top],
        "idle_gaps": [[k, v] for k, v in gap_time.most_common(TOP)],
    }


def matching(summary_, names):
    """Device µs and calls of the operations whose name contains any of
    ``names``."""
    us = sum(v for k, v in summary_["device_us"].items()
             if any(n in k for n in names))
    calls = sum(v for k, v in summary_["device_count"].items()
                if any(n in k for n in names))
    return us, calls


def breakdown(summaries):
    """The result's ``breakdown`` over the ranks' summaries: the device
    operations that took most time and the longest idle gaps by label,
    summed over ranks."""
    ops = collections.Counter()
    gaps = collections.Counter()
    for s in summaries:
        for name, sec in s["device_ops"]:
            ops[name] += sec
        for name, sec in s["idle_gaps"]:
            gaps[name] += sec
    return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}
