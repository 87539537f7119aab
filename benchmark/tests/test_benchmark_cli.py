"""``run.py`` fails without a card and prints no result; nothing the
benchmark runs loads JAX, its libraries or the JAX package, compared by
whole top-level names."""

import json
import os
import subprocess
import sys

import _paths
from harness import runner

RUN = os.path.join(_paths.FOLDER, "run.py")


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", "precession_batch_1M", "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=_paths.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copytree(_paths.FOLDER, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_paths.ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "precession_batch_1M", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_names_are_compared_whole():
    assert runner.forbidden_modules(
        ["qinfer_tpu_torch", "qinfer_tpu_torch.smc", "torch", "jaxtyping",
         "numpy"]) == []
    assert runner.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "qinfer_tpu", "qinfer_tpu.smc", "qinfer_tpu_torch"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "qinfer_tpu", "qinfer_tpu.smc"]


def test_a_run_loads_no_jax():
    """A whole run of a cell on the CPU, at a tiny size, in a fresh
    process: its modules afterwards hold none of the forbidden names."""
    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "from harness import registry, runner\n"
        "cell = registry.Registry(held=True).cell('tomography_adaptive_eig_1M')\n"
        "cell.traffic.update(n_particles=2048, steps=6, check_span_units=1,"
        " check_steps=4, check_units=1)\n"
        "res = runner.run_cell(cell, 3, 0.2, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps([res['correct'], runner.forbidden_modules()]))\n"
        % (_paths.FOLDER, _paths.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=_paths.ROOT).stdout
    correct, bad = json.loads(out.strip().splitlines()[-1])
    assert bad == []
    assert correct is True
