"""One run of one cell: set-up, the measured window, the metrics, the
comparison that decides ``correct``, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object with ``correct``,
``attempted`` (the window's units), ``failed``, ``metrics``, ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared, with its limit, which are also the last lines of standard
error. ``failed`` counts the numbers over their limit, so a correct run
has none: an answer that SMC itself gets wrong, as a bank that loses the
posterior's mode on a few records in a hundred, is judged through the
quantile that its limit is set on, and how many sampled answers lie over
the limit is printed on standard error beside it. Without a CUDA device,
or with fewer than the cell asks for, the run fails and prints no result;
it never falls back to the CPU. Nor does it print one when JAX, its
libraries or the JAX package were loaded in the process.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
import traceback

from . import registry, stats, window
from .trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "qinfer_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of ``FORBIDDEN``: ``qinfer_tpu_torch`` is not
    ``qinfer_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def device_name(device):
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def memory_peak(device):
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(torch.device(device)))
    return 0


def per_layer(cell, summaries):
    """Each per-layer metric of the cell from its reader, left out where
    the reader finds nothing to read."""
    out = {}
    for m in cell.per_layer:
        value = cell.module("metrics", m["name"]).read(summaries)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def assemble(cell, checks, attempted, e2e, summaries, device_info):
    """The result line's object from the parts of a run."""
    if summaries is None:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    else:
        metrics = per_layer(cell, summaries)
        device_info["busy_s"] = statistics.fmean(s["busy_s"]
                                                 for s in summaries)
        device_info["window_s"] = statistics.fmean(s["window_s"]
                                                   for s in summaries)
    result = {"correct": all(c.ok for c in checks) and bool(checks),
              "attempted": attempted,
              "failed": sum(not c.ok for c in checks),
              "metrics": metrics, "device": device_info}
    if summaries is not None:
        result["breakdown"] = breakdown(summaries)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def run_cell(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell`` on ``device``; the result's object. ``t_start``
    is the process's start on ``time.perf_counter``: set-up runs from it
    to the window's start."""
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(cell, seed,
                                                                device)
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t_start
    win = window.run(drv, seconds,
                     trace_seconds=cell.traffic["trace_seconds"] if trace
                     else None, device=device)
    peak = memory_peak(device)
    e2e = {"setup_s": setup_s,
           "particle_updates_per_s": stats.rate(win.work, win.seconds),
           **drv.end_to_end()}
    drv.release()
    checks = drv.check()
    summaries = None
    if trace:
        summaries = [win.trace]
    info = {"platform": "gpu" if "cuda" in str(device) else "cpu",
            "kind": device_name(device), "count": cell.chips,
            "memory_peak_bytes": peak}
    print(f"window: {win.units} units, {win.steps} steps in "
          f"{win.seconds:.6f} s; set-up {setup_s:.6f} s", file=sys.stderr)
    for c in checks:
        print(f"{c.name}: {c.failed} of {c.items} sampled answers over "
              f"{c.limit!r}", file=sys.stderr)
    return assemble(cell, checks, win.units, e2e, summaries, info)


def report_checks(result):
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    for name, c in result["checks"].items():
        verdict = "ok" if (math.isfinite(c["value"])
                           and c["value"] <= c["limit"]) else "FAILED"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    try:
        args = parse(argv)
        cell = registry.Registry().cell(args.workload)
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, torch sees "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", t_start)
    except Exception:  # the boundary: a failed run prints no result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    report_checks(result)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
