"""On the card: one short run of each one-card cell prints a result line
that keeps to the contract and comes out correct. Skips here without a
card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

import _paths
from harness import registry

CELLS = [w["name"] for w in registry.Registry().spec["workloads"]
         if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(_paths.FOLDER, "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, timeout=1200, cwd=_paths.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert {"setup_s", "particle_updates_per_s"} <= set(res["metrics"])
