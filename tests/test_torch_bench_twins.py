"""The port's twins of ``bench_scaling.py``, ``bench_soak.py`` and
``bench_breakdown.py`` (``bench_torch.py --which scaling|soak|breakdown``)
on the CPU, at small sizes.

The scaling worlds run as gloo ranks, a process each (1, 2 and 4 ranks at
2^12 particles a rank, as ``--cpu 4 --per-shard 4096`` runs them). Their
collective inventory is held against the JAX package's, lowered by
``bench_scaling.lower_step`` on the conftest's 8 virtual devices: the
all-gather migration's bank bytes per particle equal, the ring's payload
per shift equal to JAX's per permute, and every count that differs
named with its cause. The field names are read from the JAX scripts
(``ast`` where importing one would run it). Each twin without ``--cpu``
finds no card here and must fail with one error line.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import bench_scaling  # noqa: E402
import bench_torch  # noqa: E402

torch.set_num_threads(2)

PER_SHARD = 1 << 12
N_BREAKDOWN = 1 << 12


def _tree(name):
    return ast.parse((REPO / name).read_text())


def _dict_keys(func):
    """The string keys of every dict literal in ``func``'s body."""
    return {k.value for node in ast.walk(func) if isinstance(node, ast.Dict)
            for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _function(tree, name):
    return next(node for node in ast.walk(tree)
                if isinstance(node, ast.FunctionDef) and node.name == name)


@pytest.fixture(scope="module")
def scaling_rows():
    """Worlds of 1, 2 and 4 gloo ranks, one after another."""
    return bench_torch.scaling((1, 2, 4), (PER_SHARD,), cpu=4, wall_s=240)


def _inventory(rows, k, migration):
    return next(r for r in rows if r["metric"] == "collective_bytes_per_step"
                and r["devices"] == k and r["migration"] == migration)


def _jax_update_all_reduces(hlo):
    """All-reduces of the JAX step outside its resample ``cond``."""
    return sum(1 for line in hlo.splitlines()
               if re.search(r"\ball-reduce(-start)?\(", line)
               and "/cond/" not in line)


@pytest.mark.parametrize("migration", bench_torch.MIGRATIONS)
@pytest.mark.parametrize("k", [2, 4])
def test_inventory_matches_jax(scaling_rows, k, migration):
    row = _inventory(scaling_rows, k, migration)
    hlo, n = bench_scaling.lower_step(k, migration, per_shard=PER_SHARD)
    jax_inv = bench_scaling.collective_inventory(hlo)
    port = row["collectives"]
    assert row["n_particles"] == n == PER_SHARD * k
    # The update: B1's raw statistics merged by a max and a sum twice, as
    # the JAX step does outside its cond.
    assert row["update_only"] == {"all-reduce": {"count": 4, "bytes": 16}}
    assert _jax_update_all_reduces(hlo) == 4
    # All-reduces, the eager branch: the JAX HLO holds the postselection
    # loop's all-reduced check once; the port executes it once a round
    # and once more to stop. The port's ring also normalizes its CDF by
    # its own all-reduced max and f64 sum (sharded_smc._cdf_log_norm).
    ring_norm = 2 if migration == "ring" else 0
    assert port["all-reduce"]["count"] == (
        jax_inv["all-reduce"]["count"] + row["redraw_rounds"] + ring_norm)
    if migration == "all_gather":
        # Bytes per particle of the bank's gathers equal (8.0 at D = 1):
        # JAX gathers the int32 starts and the bank, the port the f32
        # log-weights and the bank. JAX's one more all-gather is its ranks'
        # int32 CDF totals (s32[K]) that offset its sharded starts; the
        # port computes one bank's starts from the gathered log-weights.
        assert port["all-gather"]["count"] == jax_inv["all-gather"]["count"] - 1
        assert port["all-gather"]["bytes"] == (
            jax_inv["all-gather"]["bytes"] - 4 * k)
        assert port["all-gather"]["bytes"] / n == 8.0
        assert "collective-permute" not in port
    else:
        # The K − 1 shifts: the port executes K − 1 shifts of the starts
        # and K − 1 of the bank (gloo refuses a send to one's own rank),
        # JAX's HLO counts each loop-carried permute once; the payload per
        # shift is JAX's per permute, a rank's block of int32 starts or
        # f32 rows.
        perm, jperm = port["collective-permute"], jax_inv["collective-permute"]
        assert (perm["count"], jperm["count"]) == (2 * (k - 1), 2)
        assert perm["bytes"] / perm["count"] == (
            jperm["bytes"] / jperm["count"]) == 4 * PER_SHARD
        # The ranks' CDF totals: int64 in the port (its integer CDF is
        # summed in int64), int32 in JAX.
        assert port["all-gather"] == {"count": 1, "bytes": 8 * k}
        assert jax_inv["all-gather"] == {"count": 1, "bytes": 4 * k}
        assert row["note"].startswith(bench_torch.RING_NOTE)
    assert row["total_bytes"] == sum(v["bytes"] for v in port.values())


def test_rows_have_bench_scaling_s_fields(scaling_rows):
    tree = _tree("bench_scaling.py")
    inv_keys = _dict_keys(_function(tree, "emit_collective_rows"))
    inventory = [r for r in scaling_rows
                 if r["metric"] == "collective_bytes_per_step"]
    assert [(r["devices"], r["migration"]) for r in inventory] == [
        (k, m) for k in (1, 2, 4) for m in bench_torch.MIGRATIONS]
    for r in inventory:
        assert inv_keys - {"note"} <= set(r)
        assert r["platform"] == "cpu"


@pytest.mark.parametrize("k", [1, 2])
def test_throughput_rows(scaling_rows, k):
    """bench_scaling.py's throughput fields, finite values, the
    efficiency against the one-rank row."""
    pps_keys = _dict_keys(_function(_tree("bench_scaling.py"),
                                    "emit_throughput_rows"))
    row = next(r for r in scaling_rows
               if r["metric"] == f"sharded_particle_updates_per_s@{k}dev")
    assert pps_keys - {"note"} <= set(row)
    base = next(r for r in scaling_rows
                if r["metric"] == "sharded_particle_updates_per_s@1dev")
    assert np.isfinite(row["value"]) and row["value"] > 0
    assert row["weak_scaling_efficiency"] == pytest.approx(
        row["value"] / (base["value"] * k))
    assert row["n_particles"] == PER_SHARD * k and row["n_exp"] == 30
    assert len(row["seconds_slowest_rank"]) == 3
    assert row["value"] == pytest.approx(
        row["n_particles"] * 30 / min(row["seconds_slowest_rank"]))
    assert all(s >= t for s, t in zip(row["seconds_slowest_rank"],
                                      row["seconds_this_rank"]))
    assert min(row["resamples"]) > 0


def test_collective_counter_restores_the_collectives():
    import torch.distributed as dist

    saved = (dist.all_reduce, dist.all_gather, dist.batch_isend_irecv)
    with bench_torch.CollectiveCounter() as counter:
        assert dist.all_reduce is not saved[0]
    assert (dist.all_reduce, dist.all_gather,
            dist.batch_isend_irecv) == saved
    assert counter.inventory == {}


def test_soak_has_bench_soak_s_fields_and_passes_its_gate():
    """T = 16, N = 256, 20 steps: ``soak`` raises on a failed gate."""
    keys = _dict_keys(_function(_tree("bench_soak.py"), "main"))
    line = bench_torch.soak(16, 256, 20, device="cpu")
    assert keys <= set(line)
    assert line["op"] == "soak_16x256x20" and line["n_trials"] == 16
    assert line["median_loss_last"] < 1e-3 < line["median_loss_first"]
    assert line["wall_s"] >= line["device_s"] > 0
    assert line["device_pps"] == pytest.approx(16 * 256 * 20
                                               / line["device_s"])
    assert 0.0 <= line["chains_converged_pct"] <= 100.0
    assert line["steps_resampled"] > 0


def _jax_breakdown_ops():
    """The op names of bench_breakdown.py's ``timed(...)`` calls, in order."""
    return [node.args[0].value for node in ast.walk(_tree("bench_breakdown.py"))
            if isinstance(node, ast.Call) and getattr(node.func, "id", None)
            == "timed"]


def test_breakdown_ops_are_bench_breakdown_s():
    """The same 14 names in the same order, less the one rename; the same
    bytes_moved and iterations."""
    names = [op[0] for op in bench_torch.breakdown_ops(N_BREAKDOWN, "cpu")]
    jax = _jax_breakdown_ops()
    assert len(jax) == 14
    assert names == [("systematic_pick_D1"
                      if n == "systematic_pick_blocked_D1" else n)
                     for n in jax]
    calls = [node for node in ast.walk(_tree("bench_breakdown.py"))
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "timed"]
    for call, op in zip(calls, bench_torch.breakdown_ops(N_BREAKDOWN, "cpu")):
        kw = {k.arg: k.value for k in call.keywords}
        nbytes = kw["bytes_moved"]  # c * N
        assert op[3] == nbytes.left.value * N_BREAKDOWN
        iters = kw["iters"].value if "iters" in kw else 30
        assert op[4] == iters


@pytest.mark.parametrize("name", [op[0] for op in bench_torch.breakdown_ops(
    N_BREAKDOWN, "cpu")])
def test_breakdown_op_runs(name):
    (line,) = bench_torch.breakdown(N_BREAKDOWN, "cpu", names={name})
    assert line["op"] == name and line["n"] == N_BREAKDOWN
    assert line["ms"] > 0 and np.isfinite(line["gbps"])
    assert len(line["ms_runs"]) == 3
    assert ("note" in line) == (name == "systematic_pick_D1")


@pytest.mark.parametrize("which", ["scaling", "soak", "breakdown"])
def test_twin_without_a_card_fails_with_one_error_line(which):
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--which", which],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 1
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["phase"] == which and "CUDA" in line["error"]
