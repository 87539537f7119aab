"""The per-layer metrics that read the program's own spans
(``qinfer_tpu_torch.profiling.recorded()``): each reader on a synthetic
recording; the readers on the recordings of a real ``smc_batch_update``
and a real ``perf_test_multiple``, where every span the program opened is
read by one of them and their sum is the spans' time; and short traced
runs of both cells on the CPU that report them."""

import json
import subprocess
import sys

import pytest

import _paths
from harness import registry

READERS = ("step_host_us", "b1_host_us", "resample_host_us", "sync_wait_us",
           "trial_host_us")


def _agg(total, self_=None):
    return {"count": 1, "total_ns": total,
            "self_ns": total if self_ is None else self_, "parents": {}}


# Four steps of a trial loop: 1 ms in all, split among the layers.
RECORDING = {
    "counters": {"smc.steps": 4},
    "spans": {
        "qinfer.perf_testing.step": _agg(1_000_000, 40_000),
        "qinfer.design.propose": _agg(60_000),
        "qinfer.perf_testing.record": _agg(20_000),
        "qinfer.smc.step": _agg(880_000, 80_000),
        "qinfer.smc.update": _agg(300_000, 100_000),
        "qinfer.ops.b1": _agg(200_000),
        "qinfer.sync.mask": _agg(120_000),
        "qinfer.resamplers.resample": _agg(380_000, 30_000),
        "qinfer.resamplers.moments": _agg(150_000),
        "qinfer.ops.b2": _agg(50_000),
        "qinfer.resamplers.postselect": _agg(150_000, 110_000),
        "qinfer.sync.postselect": _agg(40_000),
        "user.block": _agg(5_000),
    },
}
WANT = {"step_host_us": 45.0, "b1_host_us": 50.0, "resample_host_us": 85.0,
        "sync_wait_us": 40.0, "trial_host_us": 30.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_recording(name):
    reader = registry.Registry().module("metrics", name)
    assert reader.value(RECORDING) == pytest.approx(WANT[name])
    assert reader.value({"counters": {}, "spans": {}}) is None
    no_steps = dict(RECORDING, counters={"smc.steps": 0})
    assert reader.value(no_steps) is None


def test_readers_split_the_loop_without_overlap():
    """The five metrics add up to the outermost span's time a step."""
    total = sum(WANT.values())
    assert total == pytest.approx(
        RECORDING["spans"]["qinfer.perf_testing.step"]["total_ns"] / 1e3 / 4)


def _real_recording(run):
    """``profiling.recorded()`` of a small profiled run on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import qinfer_tpu_torch as qt
    from qinfer_tpu_torch import profiling

    model = qt.SimplePrecessionModel()
    prior = qt.UniformDistribution([[0, 1]])
    if run == "batch_update":
        g = torch.Generator().manual_seed(4)
        state = qt.init_smc_state(g, model, 1000, prior)
        ts = torch.tensor([1.3 ** k for k in range(20)])
        outcomes = (torch.rand(20, generator=g) < 0.5).to(torch.int32)

        def fn():
            qt.smc_batch_update(
                model, qt.LiuWestResampler(a=0.98),
                qt.SMCConfig(zero_weight_policy="reset",
                             use_fused_update=True),
                state, outcomes, {"t": ts})
    else:
        def fn():
            qt.perf_test_multiple(
                4, model, 256, prior, 5, qt.PGH, seed=3, device="cpu",
                extra_updater_args={"use_fused_update": True})
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.recorded()


@pytest.mark.parametrize("run", ["batch_update", "ensemble"])
def test_readers_split_a_real_recording(run):
    """Every span the program opened is read by exactly one of the five
    metrics, and together they read the whole of the spans' time: their sum
    a step times the steps is the spans' self time in all, which is the
    outermost spans' time."""
    rec = _real_recording(run)
    readers = [registry.Registry().module("metrics", n) for n in READERS]
    spans = rec["spans"]
    steps = rec["counters"]["smc.steps"]
    assert steps > 0 and spans
    for name in spans:
        assert name.startswith("qinfer."), name
        assert sum(r.matches(name) for r in readers) == 1, name
    read_ns = sum((r.value(rec) or 0.0) for r in readers) * 1e3 * steps
    self_ns = sum(a["self_ns"] for a in spans.values())
    assert read_ns == pytest.approx(self_ns, rel=1e-12)
    roots = {n: a for n, a in spans.items() if None in a["parents"]}
    only_roots = sum(a["total_ns"] for a in roots.values()
                     if a["parents"] == {None: a["count"]})
    assert only_roots <= self_ns <= sum(a["total_ns"] for a in roots.values())
    if run == "batch_update":
        assert set(roots) == {"qinfer.smc.step"}
        assert self_ns == spans["qinfer.smc.step"]["total_ns"]
    else:
        assert "qinfer.perf_testing.step" in roots


CELLS = {
    "precession_batch_1M": {"n_exp": 20, "n_particles": 4096,
                            "check_units": 2, "trace_seconds": 0.1},
    "precession_ensemble_256x2048": {"trials": 4, "particles": 256,
                                     "n_exp": 5, "check_span_units": 1,
                                     "check_units": 1, "check_trials": 2,
                                     "trace_seconds": 0.1},
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_traced_cpu_run_reports_the_span_metrics(name):
    """A short traced run on the CPU, in a fresh process, with B1's plain
    version on the step's path."""
    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "from harness import registry, runner\n"
        "cell = registry.Registry().cell(%r)\n"
        "cell.traffic.update(json.loads(%r))\n"
        "cell.config['smc']['use_fused_update'] = True\n"
        "res = runner.run_cell(cell, 2 ** 31 + 7, 0.3, True, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(res['metrics']))\n"
        % (_paths.FOLDER, _paths.ROOT, name, json.dumps(CELLS[name])))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=_paths.ROOT).stdout
    metrics = json.loads(out.strip().splitlines()[-1])
    cell = registry.Registry().cell(name)
    want = {m["name"] for m in cell.per_layer if m["name"] in READERS}
    assert want == ({"step_host_us", "b1_host_us", "resample_host_us",
                     "sync_wait_us"}
                    | ({"trial_host_us"} if "ensemble" in name else set()))
    for m in want:
        assert metrics[m]["unit"] == "us/step"
        assert metrics[m]["value"] > 0, m
