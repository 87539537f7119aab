"""launches_per_step (launches/step): the CUDA kernel launches the host
made in the traced stretch (the profiler's runtime and driver launch
calls) over the steps in it; a step is one update of the bank, or of all
trials for the batched step. Averaged over the ranks."""

import statistics


def read(summaries):
    vals = []
    for s in summaries:
        steps = s["counters"].get("steps", 0)
        launches = sum(n for name, n in s["host_calls"].items()
                       if name.startswith(("cudaLaunch", "cuLaunch")))
        if steps > 0 and launches > 0:
            vals.append(launches / steps)
    return statistics.fmean(vals) if vals else None
