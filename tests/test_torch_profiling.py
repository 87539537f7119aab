"""The program's spans and counters (``qinfer_tpu_torch.profiling``), CPU.

With no profiler a span is one shared no-op and records nothing, the
program's counters stand still, and the wrappers' own attributes count as
ever. Under ``torch.profiler.profile`` a small
``smc_batch_update`` and a small ``perf_test_multiple`` record the span
tree (counts, parents, self time = duration − the children's), one ESS
read a step, and the counters' increase over the stretch alone; each span
is also a host event of the profiler's trace, around the aten ops of its
block.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import profiling, smc

torch.set_num_threads(2)

N = 1000
N_EXP = 20


def _record(fused=True, seed=1):
    """A small bank and a record of ``N_EXP`` outcomes; ``fused`` runs B1's
    plain version under its span."""
    g = torch.Generator().manual_seed(seed)
    model = qt.SimplePrecessionModel()
    state = smc.init_smc_state(g, model, N, qt.UniformDistribution([[0, 1]]))
    ts = torch.tensor([1.3 ** k for k in range(N_EXP)], dtype=torch.float32)
    outcomes = (torch.rand(N_EXP, generator=g) < 0.5).to(torch.int32)
    config = smc.SMCConfig(resample_thresh=0.5, zero_weight_policy="reset",
                           use_fused_update=fused)
    return model, qt.LiuWestResampler(a=0.98), config, state, outcomes, ts


def _batch_update(record):
    model, resampler, config, state, outcomes, ts = record
    return smc.smc_batch_update(model, resampler, config, state, outcomes,
                                {"t": ts})


def _ensemble(n_trials=4, n_exp=5):
    return qt.perf_test_multiple(
        n_trials, qt.SimplePrecessionModel(), 256,
        qt.UniformDistribution([[0, 1]]), n_exp, qt.PGH, seed=3,
        device="cpu", extra_updater_args={"use_fused_update": True})


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.recorded(), prof.profiler.kineto_results.events()


def _children(spans, name):
    return [c for c, a in spans.items() if name in a["parents"]]


def test_no_profiler_records_nothing_and_counters_count():
    """Off, a span is the shared no-op and the program's counters stand
    still; the wrappers' attributes count as before."""
    from qinfer_tpu_torch.ops import fused_update as b1

    assert profiling.span("qinfer.smc.step") is profiling.span("other")
    record = _record()
    _batch_update(record)  # outside any profiler
    before_rec = profiling.recorded()
    before = profiling.counters()
    profiling.count("smc.steps", 5)
    state, _ = _batch_update(record)
    assert int(state.n_resamples) > 0
    wrapper = b1.fused_bayes_update
    launches, user = wrapper.launches, wrapper.user_launches
    b1._count(wrapper, "user", 1)
    assert (wrapper.launches, wrapper.user_launches) == (launches + 1,
                                                         user + 1)
    assert profiling.counters() == before
    assert profiling.recorded() == before_rec
    # While a profiler records, the same launch is on the counters too.
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("user.block"):
            b1._count(wrapper, "user", 1)
    counted = profiling.recorded()["counters"]
    assert counted == {"ops.fused_bayes_update.launches": 1,
                       "ops.fused_bayes_update.user_launches": 1}
    assert wrapper.user_launches == user + 2


def test_wide_launches_count_over_16_columns():
    """B1's launches of more than 16 columns (the three-qubit Born tile)
    count as wide, on the wrapper's attribute always and on the program's
    counter while a profiler records."""
    from qinfer_tpu_torch.ops import fused_update as b1

    wrapper = b1.fused_bayes_update
    wide = wrapper.wide_launches
    b1._count(wrapper, "builtin", 16)
    assert wrapper.wide_launches == wide
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("user.block"):
            b1._count(wrapper, "builtin", 64)
            b1._count(wrapper, "builtin", 4)
    assert profiling.recorded()["counters"] == {
        "ops.fused_bayes_update.launches": 2,
        "ops.fused_bayes_update.wide_launches": 1}
    assert wrapper.wide_launches == wide + 1


def test_counters_that_did_not_grow_are_left_out():
    """After a stretch whose step counted, the next stretch reports only
    what it counted itself; then the test above holds in the same process
    (the order in which another test file can leave it)."""
    _profiled(lambda: _batch_update(_record()))
    assert profiling.counters()["smc.steps"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("user.block"):
            profiling.count("user.counter", 2)
    assert profiling.recorded()["counters"] == {"user.counter": 2}
    test_no_profiler_records_nothing_and_counters_count()


def test_batch_update_span_tree():
    record = _record()
    (state, _), rec, _ = _profiled(lambda: _batch_update(record))
    spans = rec["spans"]
    steps = rec["counters"]["smc.steps"]
    resampled = int(state.n_resamples)
    assert steps == N_EXP and resampled > 0
    parents = {
        "qinfer.smc.step": {None: N_EXP},
        "qinfer.smc.update": {"qinfer.smc.step": N_EXP},
        "qinfer.ops.b1": {"qinfer.smc.update": N_EXP},
        "qinfer.sync.ess": {"qinfer.smc.step": N_EXP},
        "qinfer.resamplers.resample": {"qinfer.smc.step": resampled},
        "qinfer.resamplers.moments": {"qinfer.resamplers.resample":
                                      resampled},
        "qinfer.ops.b2": {"qinfer.resamplers.resample": resampled},
        "qinfer.resamplers.postselect": {"qinfer.resamplers.resample":
                                         resampled},
    }
    for name, want in parents.items():
        assert spans[name]["parents"] == want, name
        assert spans[name]["count"] == sum(want.values()), name
    checks = spans["qinfer.sync.postselect"]
    assert checks["parents"] == {"qinfer.resamplers.postselect":
                                 checks["count"]}
    assert checks["count"] >= resampled
    # Each validity test is followed by its check; no row was clamped.
    valid = spans["qinfer.resamplers.valid"]
    assert valid["parents"] == {"qinfer.resamplers.postselect":
                                checks["count"]}
    assert rec["counters"]["resamplers.LiuWestResampler.tested_rows"] == (
        valid["count"] * state.particle_locations.shape[0])
    assert "resamplers.LiuWestResampler.clamped_rows" not in rec["counters"]
    assert set(spans) == set(parents) | {"qinfer.sync.postselect",
                                         "qinfer.resamplers.valid"}
    # Self time is the duration less the children's (each child here has
    # one parent).
    for name, a in spans.items():
        kids = sum(spans[c]["total_ns"] for c in _children(spans, name))
        assert a["self_ns"] == a["total_ns"] - kids, name
        assert 0 <= a["self_ns"] <= a["total_ns"]


def test_ensemble_span_tree():
    n_trials, n_exp = 4, 5
    _, rec, _ = _profiled(lambda: _ensemble(n_trials, n_exp))
    spans = rec["spans"]
    steps = rec["counters"]["smc.steps"]
    assert steps == n_exp + 2  # the call's warm-up makes two steps
    loop = {"qinfer.perf_testing.step": steps}
    for name in ("qinfer.design.propose", "qinfer.perf_testing.simulate",
                 "qinfer.smc.step", "qinfer.perf_testing.record"):
        assert spans[name]["parents"] == loop, name
    assert spans["qinfer.perf_testing.step"]["parents"] == {None: steps}
    assert spans["qinfer.sync.mask"]["count"] == steps
    assert spans["qinfer.ops.b1"]["parents"] == {"qinfer.smc.update": steps}
    # The warm-up's and the timed run's records, each read once.
    assert spans["qinfer.sync.records"]["parents"] == {None: 2}
    # The masked resamples of the steps, and the warm-up's own of all
    # trials outside any step.
    calls = spans["qinfer.resamplers.resample"]["count"]
    assert spans["qinfer.resamplers.resample"]["parents"] == {
        "qinfer.smc.step": calls - 1, None: 1}
    assert spans["qinfer.ops.b2"]["count"] == calls
    step = spans["qinfer.perf_testing.step"]
    kids = sum(spans[c]["total_ns"] for c in _children(
        spans, "qinfer.perf_testing.step"))
    assert step["self_ns"] == step["total_ns"] - kids


def test_recorded_counters_are_the_stretch_s_alone():
    record = _record(seed=2)
    _batch_update(record)  # before
    rounds0 = qt.LiuWestResampler.redraw_rounds
    (state, _), _, _ = _profiled(lambda: _batch_update(record))
    rounds = qt.LiuWestResampler.redraw_rounds - rounds0
    _batch_update(record)  # after
    rec = profiling.recorded()
    assert rec["counters"]["smc.steps"] == N_EXP
    assert rec["spans"]["qinfer.resamplers.resample"]["count"] == int(
        state.n_resamples)
    assert rec["counters"].get(
        "resamplers.LiuWestResampler.redraw_rounds", 0) == rounds
    assert rec["spans"]["qinfer.sync.ess"]["count"] == N_EXP
    # The next stretch starts fresh.
    _, rec2, _ = _profiled(lambda: _batch_update(_record(seed=3)))
    assert rec2["counters"]["smc.steps"] == N_EXP
    assert rec2["spans"]["qinfer.smc.step"]["count"] == N_EXP


@pytest.mark.parametrize("run", ["batch_update", "ensemble"])
def test_spans_are_host_events_around_their_aten_ops(run):
    fn = ((lambda: _batch_update(_record())) if run == "batch_update"
          else _ensemble)
    _, rec, events = _profiled(fn)
    cpu = torch.autograd.DeviceType.CPU
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == cpu]
    spans = sorted(h for h in host if h[2].startswith("qinfer."))
    assert (collections.Counter(n for _, _, n in spans)
            == {n: a["count"] for n, a in rec["spans"].items()})

    def innermost(a, b):
        inside = [s for s in spans if s[0] <= a and b <= s[1]]
        return max(inside)[2] if inside else None

    ops = collections.defaultdict(set)
    for a, b, name in host:
        if name.startswith("aten::"):
            ops[innermost(a, b)].add(name)
    assert "aten::linalg_eigh" in ops["qinfer.resamplers.moments"]
    assert "aten::is_nonzero" in ops["qinfer.sync.postselect"]
    if run == "batch_update":
        assert "aten::is_nonzero" in ops["qinfer.sync.ess"]
        assert "aten::amax" in ops["qinfer.ops.b1"]
    else:
        assert "aten::nonzero" in ops["qinfer.sync.mask"]
        assert "aten::einsum" in ops["qinfer.perf_testing.record"]
    # A child's event lies inside one of its parent's.
    for a, b, name in spans:
        parents = rec["spans"][name]["parents"]
        if None not in parents:
            assert any(s[0] <= a and b <= s[1] and s[2] in parents
                       for s in spans), name


def test_same_name_folds_and_annotate_is_a_span():
    def block():
        with profiling.annotate("user.block"):
            with profiling.span("user.block"):
                with profiling.span("user.inner"):
                    torch.ones(3).sum()

    _, rec, events = _profiled(block)
    assert rec["spans"]["user.block"]["count"] == 1
    assert rec["spans"]["user.inner"]["parents"] == {"user.block": 1}
    names = [e.name() for e in events]
    assert names.count("user.block") == 1 and "user.inner" in names
