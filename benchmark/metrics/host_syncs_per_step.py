"""host_syncs_per_step (syncs/step): the times the host waited for the
device in the traced stretch (the profiler's stream, device and event
synchronizations and blocking copies) over the steps in it. Averaged
over the ranks."""

import statistics

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
         "cuCtxSynchronize", "cuEventSynchronize")


def read(summaries):
    vals = []
    for s in summaries:
        steps = s["counters"].get("steps", 0)
        syncs = sum(s["host_calls"].get(name, 0) for name in SYNCS)
        if steps > 0:
            vals.append(syncs / steps)
    return statistics.fmean(vals) if vals else None
