"""A cell, a configuration (with a model class and a plain reference that
no other configuration uses) and a per-layer metric added as files and
``BENCHMARK.json`` entries are found and run without editing the
harness."""

import json
import shutil
import time

import _paths
from harness import port, registry, runner

T2 = 5.0

METRIC = '''"""resamples_per_step (resamples/step): the resamples in the traced
stretch over its steps."""


def read(summaries):
    c = summaries[0]["counters"]
    return c["resamples"] / c["steps"] if c.get("steps") else None
'''


def test_added_files_are_found(tmp_path):
    shutil.copytree(_paths.FOLDER, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(open(f"{_paths.ROOT}/BENCHMARK.json").read())
    folder = tmp_path / "benchmark"

    # Precession with a known T2: Pr(0) = (1 + e^(-t/T2) cos(wt)) / 2, on
    # the upper half of the frequencies, judged by a reference of its own.
    config = json.loads((folder / "configs/simple_precession.json")
                        .read_text())
    config.update(
        name="precession_t2",
        model={"call": "qinfer_tpu_torch.KnownT2PrecessionModel",
               "kwargs": {"t2": T2}},
        prior={"call": "qinfer_tpu_torch.UniformDistribution",
               "kwargs": {"ranges": [[0.5, 1.0]]}},
        reference="precession_t2")
    (folder / "configs/precession_t2.json").write_text(json.dumps(config))
    src = (folder / "reference/precession.py").read_text()
    plain = "lik = 0.5 * (1.0 + (1.0 - 2.0 * o) * avg_cos)"
    assert plain in src
    (folder / "reference/precession_t2.py").write_text(src.replace(
        plain, f"lik = 0.5 * (1.0 + (1.0 - 2.0 * o) * torch.exp(-t / {T2})"
        " * avg_cos)"))
    traffic = json.loads((folder / "traffic/record_batch.json").read_text())
    traffic.update(n_exp=20, n_particles=4096, check_units=2,
                   trace_seconds=0.1)
    (folder / "traffic/record_short.json").write_text(json.dumps(traffic))
    (folder / "metrics/resamples_per_step.py").write_text(METRIC)

    spec["configs"].append({
        "name": "precession_t2", "source": "https://example.org/x",
        "file": "benchmark/configs/precession_t2.json",
        "reduced": [], "why": "a test"})
    spec["workloads"].append({
        "name": "precession_short", "config": "precession_t2",
        "traffic": "record_short", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "particle_updates_per_s":
            m["workloads"].append("precession_short")
    spec["per_layer"].append({
        "name": "resamples_per_step", "unit": "resamples/step",
        "better": "lower", "source": "program_counter", "layer": "smc",
        "moves": "particle_updates_per_s",
        "workloads": ["precession_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = registry.Registry(tmp_path).cell("precession_short")
    system = port.build(cell.config, 64)
    assert type(system.model).__name__ == "KnownT2PrecessionModel"
    assert system.model.t2 == T2
    assert cell.traffic["n_exp"] == 20
    assert [m["name"] for m in cell.per_layer if m["name"]
            == "resamples_per_step"] == ["resamples_per_step"]

    res = runner.run_cell(cell, 11, 0.3, True, "cpu", time.perf_counter())
    assert "resamples_per_step" in res["metrics"]
    assert res["correct"] is True
    res = runner.run_cell(cell, 12, 0.3, False, "cpu", time.perf_counter())
    assert set(res["metrics"]) == {"particle_updates_per_s", "setup_s"}
