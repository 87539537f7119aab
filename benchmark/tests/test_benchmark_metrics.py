"""The metric arithmetic on synthetic inputs: the percentile with its
sample count, the union of intervals, the rate to the end of the last
unit, the bytes of a call, and each per-layer reader."""

import time
import types

import pytest

import _paths  # noqa: F401
from harness import compare, registry, roofline, runner, stats, trace, window


def test_percentile_nearest_rank_and_count():
    xs = list(range(1, 1001))  # 1 … 1000
    p99, beyond = stats.percentile(xs, 99)
    assert (p99, beyond) == (990, 10)
    assert stats.percentile([5.0], 99) == (5.0, 0)
    assert stats.percentile([3, 1, 2], 50) == (2, 1)
    with pytest.raises(ValueError):
        stats.percentile([], 99)


def test_union_of_intervals():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert stats.merged(iv) == [[0, 12], [20, 30], [40, 41]]
    assert sum(b - a for a, b in stats.merged(iv)) == 12 + 10 + 1
    assert stats.merged([]) == []


def test_rate():
    assert stats.rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_failed_counts_the_numbers_over_their_limit():
    # A quarter of the sampled answers over the limit: the median holds.
    q = compare.median("gap", [1.0, 2.0, 3.0, 9.0], 5.0)
    assert q.ok and (q.items, q.failed) == (4, 1)
    over = compare.worst("widest", [1.0, 9.0], 5.0)
    cell = types.SimpleNamespace(end_to_end=[], per_layer=[])
    res = runner.assemble(cell, [q], 40, {}, None, {})
    assert (res["correct"], res["attempted"], res["failed"]) == (True, 40, 0)
    res = runner.assemble(cell, [q, over], 40, {}, None, {})
    assert (res["correct"], res["failed"]) == (False, 1)
    assert list(res)[-1] == "checks"


class _Units:
    """A driver whose units take a fixed time each, their ends kept."""

    def __init__(self, seconds):
        self.seconds = seconds
        self.count = {}
        self.ends = []

    def sync(self):
        pass

    def counters(self):
        return dict(self.count)

    def unit(self, i):
        time.sleep(self.seconds)
        self.ends.append(time.perf_counter())
        return {"work": 10, "steps": 2}


def test_window_runs_to_the_end_of_the_last_unit():
    drv = _Units(0.03)
    t0 = time.perf_counter()
    win = window.run(drv, 0.1, device="cpu")
    ends = [e - t0 for e in drv.ends]
    # the unit that crosses 0.1 s finishes, counts whole and is the last
    assert ends[-1] >= 0.1 and all(e < 0.1 for e in ends[:-1])
    assert win.seconds >= 0.1 and abs(win.seconds - ends[-1]) < 0.02
    assert win.units == len(ends)
    assert win.work == 10 * win.units and win.steps == 2 * win.units


def test_bytes_of_a_call():
    n = 1 << 20
    # the precession update: log-weights in and out, one column
    assert roofline.b1_bytes(n, 1) == 12 * n
    assert abs(roofline.least_seconds(roofline.b1_bytes(n, 1))
               - 3.756e-6) < 1e-9
    assert roofline.b1_bytes(n, 4) == 24 * n
    # starts in, rows out
    assert roofline.b2_bytes(n, n, 1) == 8 * n
    assert roofline.b2_bytes(4 * n, n, 1) == 20 * n


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def _summary():
    ev = [
        _Event("bench.update", 0, 1000, False),
        _Event("cudaLaunchKernel", 10, 5, False),
        _Event("cudaLaunchKernel", 300, 5, False),
        _Event("cudaStreamSynchronize", 500, 400, False),
        _Event("void fused_update_one<Outcome>(...)", 100, 200, True),
        _Event("void expand_merge(...)", 250, 150, True),
        _Event("Memcpy DtoH", 800, 50, True),
        # host spans the trace mirrors on the device are not device work
        _Event("bench.update", 0, 1000, True),
        _Event("nccl:all_reduce", 400, 400, True),
    ]
    return trace.summary(ev, 1e-6, {"steps": 2, "b1_bytes": 3350,
                                    "b2_bytes": 670, "resamples": 1,
                                    "redraw_rounds": 3,
                                    "design_ms": [1.0, 2.0, 9.0]})


def test_trace_summary():
    s = _summary()
    assert s["busy_s"] == pytest.approx((300 + 50) * 1e-9)
    assert s["host_calls"] == {"cudaLaunchKernel": 2,
                               "cudaStreamSynchronize": 1}
    # the gap 400 … 800 lies in the span and the host's synchronize
    assert s["idle_gaps"] == [["bench.update > cudaStreamSynchronize",
                               pytest.approx(400e-9)]]
    assert s["device_ops"][0][0].startswith("void fused_update_one")
    mirrored = trace.summary([_Event("nccl:all_reduce", 0, 900, True),
                              _Event("bench.update", 0, 900, True),
                              _Event("ncclDevKernel_AllReduce", 10, 100,
                                     True)], 1e-6, {})
    assert mirrored["busy_s"] == pytest.approx(100e-9)


def test_metric_readers():
    reg = registry.Registry()
    s = _summary()

    def read(name):
        return reg.module("metrics", name).read([s])

    # 3350 bytes at 3.35e12 B/s = 1 ns, against 200 ns of B1
    assert read("b1_roofline") == pytest.approx(0.5)
    assert read("b2_roofline") == pytest.approx(100 * 0.2e-9 / 150e-9)
    assert read("device_idle_share") == pytest.approx(65.0)
    assert read("launches_per_step") == 1.0
    assert read("host_syncs_per_step") == 0.5
    assert read("postselect_rounds_per_resample") == 3.0
    assert read("design_ms_p50") == 2.0


@pytest.mark.parametrize("held", [False, True])
def test_readers_find_nothing_to_read(held):
    reg = registry.Registry(held=held)
    empty = trace.summary([], 1.0, {"steps": 0})
    for m in reg.spec["per_layer"]:
        assert reg.module("metrics", m["name"]).read([empty]) is None, m


@pytest.mark.parametrize("held", [False, True])
def test_every_cell_reports_what_the_contract_asks(held):
    """Every cell of BENCHMARK.json, and with ``held`` every cell held
    back from it as well, once its entries are merged in."""
    reg = registry.Registry(held=held)
    names = [w["name"] for w in reg.spec["workloads"]]
    assert len(names) == len(set(names))
    assert ("tomography_adaptive_eig_1M" in names) is held
    for w in reg.spec["workloads"]:
        cell = reg.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert hasattr(cell.module("metrics", m["name"]), "read")
        assert isinstance(cell.module("drivers", cell.traffic["driver"]),
                          types.ModuleType)
