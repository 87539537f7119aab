"""The port's auxiliary modules against the JAX package (CPU):
checkpointing, profiling, clustering and metrics with the cluster
estimators and ``ClusteringResampler``, the rebit plots, the progress bar,
the version and the exception types.

Checkpoints: a port updater resumes bit for bit from its ``.npz`` (the
generator's byte state rides along) and from ``save_torch``, per rank under
a process group (here one gloo rank; ``test_torch_parallel.py`` runs
four); a JAX-written ``.npz`` loads into the port with ``est_mean`` within
1e-7. The clustering runs on the host with scikit-learn, in both packages
on the same bank: the same labels, the moments within f32 rounding.
"""

import datetime
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
import torch.distributed as dist

import qinfer_tpu as qi
import qinfer_tpu.tomography as jt
import qinfer_tpu_torch as qt
from qinfer_tpu_torch import checkpointing, profiling
from qinfer_tpu_torch import tomography as tt
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

matplotlib.use("Agg")
torch.set_num_threads(2)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EP = {"t": np.array([1.0], np.float32)}


def _updater(seed, n=500, **kw):
    return qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                         qt.UniformDistribution([0.0, 1.0]), seed=seed,
                         device="cpu", **kw)


def _feed(u, steps, start=0):
    for k in range(start, start + steps):
        u.update(k % 2, {"t": np.array([1.0 + 3.0 * k], np.float32)})


def _same_state(a, b):
    for name in ("particle_locations", "particle_log_weights", "n_resamples",
                 "min_n_ess", "log_total_likelihood", "n_zero_weight_events"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), name


def test_npz_round_trip_resumes_bit_for_bit(tmp_path):
    u = _updater(0)
    _feed(u, 5)
    checkpointing.save_npz(tmp_path / "ckpt.npz", u)
    u2 = _updater(99, n=300)
    checkpointing.load_npz(tmp_path / "ckpt.npz", u2)
    _same_state(u, u2)
    assert u2.n_particles == 500
    assert u2.normalization_record == u.normalization_record
    assert u2._call_count == u._call_count
    assert len(u2.data_record) == 5
    np.testing.assert_array_equal(u2.data_record[3][1]["t"],
                                  u.data_record[3][1]["t"])
    # The generator resumes: the next updates resample identically.
    _feed(u, 15, start=5)
    _feed(u2, 15, start=5)
    assert u.resample_count > 1
    _same_state(u, u2)


def test_jax_written_npz_loads_into_the_port(tmp_path):
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), 500,
                       qi.UniformDistribution([0.0, 1.0]), seed=0)
    for k in range(6):
        ju.update(jnp.int32(k % 2),
                  {"t": jnp.array([1.0 + 3.0 * k], jnp.float32)})
    qi.checkpointing.save_npz(tmp_path / "jax.npz", ju)
    u = _updater(5, n=100)
    checkpointing.load_npz(tmp_path / "jax.npz", u)
    np.testing.assert_allclose(u.est_mean().numpy(), np.asarray(ju.est_mean()),
                               atol=1e-7)
    np.testing.assert_array_equal(u.particle_log_weights.numpy(),
                                  np.asarray(ju.particle_log_weights))
    assert u.resample_count == ju.resample_count
    assert u.normalization_record == [float(x)
                                      for x in ju.normalization_record]
    assert len(u.data_record) == 6
    # The JAX key has no torch meaning: the generator is seeded from its
    # bytes, the same every time.
    again = _updater(7, n=100)
    checkpointing.load_npz(tmp_path / "jax.npz", again)
    assert torch.equal(u.state.generator.get_state(),
                       again.state.generator.get_state())
    u.update(1, {"t": np.array([2.0], np.float32)})


def test_save_torch_round_trip(tmp_path):
    u = _updater(1)
    _feed(u, 8)
    checkpointing.save_torch(tmp_path / "ckpt", u)
    assert (tmp_path / "ckpt" / "state.pt").exists()
    u2 = checkpointing.load_torch(tmp_path / "ckpt", _updater(2))
    _same_state(u, u2)
    _feed(u, 10, start=8)
    _feed(u2, 10, start=8)
    _same_state(u, u2)


def test_save_torch_writes_one_file_a_rank(tmp_path):
    """Under a process group (one gloo rank here) each rank writes and
    reads its own shard file."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        u = _updater(3)
        _feed(u, 4)
        checkpointing.save_torch(tmp_path / "ckpt", u, group=group)
        assert [p.name for p in (tmp_path / "ckpt").iterdir()] == [
            "shard-0-of-1.pt"]
        u2 = checkpointing.load_torch(tmp_path / "ckpt", _updater(4),
                                      group=group)
        _same_state(u, u2)
    finally:
        dist.destroy_process_group()


def test_throughput_meter_trace_and_annotate(tmp_path):
    meter = profiling.ThroughputMeter()
    u = _updater(0, n=1000)
    with profiling.trace(tmp_path / "trace") as prof:
        with meter.measure(3 * 1000, sync=u.particle_log_weights):
            with profiling.annotate("qinfer_batch_update"):
                u.batch_update(np.array([0, 1, 0], np.int32),
                               {"t": np.array([1.0, 2.0, 3.0], np.float32)})
    report = meter.report()
    assert report["particle_updates"] == 3000
    assert report["seconds"] > 0 and report["particle_updates_per_s"] > 0
    assert meter.particles_per_second == report["particle_updates_per_s"]
    trace_file = tmp_path / "trace" / "trace.json"
    assert trace_file.stat().st_size > 0
    names = {e.get("name") for e in json.loads(
        trace_file.read_text())["traceEvents"]}
    assert "qinfer_batch_update" in names
    assert any(e.key == "qinfer_batch_update" for e in prof.key_averages())


def _bimodal(seed=0, n=2000):
    """The bank of the JAX package's cluster test
    (tests/test_aux_subsystems.py:118-132): two narrow modes at 0.2, 0.8."""
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), n, qi.MixtureDistribution(
        [0.5, 0.5], [qi.NormalDistribution(0.2, 1e-4),
                     qi.NormalDistribution(0.8, 1e-4)]), seed=seed)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                       qt.UniformDistribution([0.0, 1.0]), device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    return ju, tu


def test_cluster_estimators_match_jax():
    ju, tu = _bimodal()
    moments = list(tu.est_cluster_moments({"eps": 0.1}))
    ref = list(ju.est_cluster_moments({"eps": 0.1}))
    assert [m[0] for m in moments] == [m[0] for m in ref]
    labels = [m[0] for m in moments if m[0] != qt.NOISE]
    assert len(labels) == 2
    means = sorted(float(m[2][0]) for m in moments if m[0] != qt.NOISE)
    np.testing.assert_allclose(means, [0.2, 0.8], atol=0.05)
    for (_, w_t, mu_t, cov_t), (_, w_j, mu_j, cov_j) in zip(moments, ref):
        np.testing.assert_allclose(w_t, w_j, rtol=1e-6)
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
        np.testing.assert_allclose(cov_t, cov_j, rtol=1e-4, atol=1e-12)
    metrics = tu.est_cluster_metrics({"eps": 0.1})
    assert metrics["n_clusters"] == 2
    assert 0.3 < metrics["largest_cluster_weight"] < 0.7
    ref_metrics = ju.est_cluster_metrics({"eps": 0.1})
    assert metrics["n_clusters"] == ref_metrics["n_clusters"]
    np.testing.assert_allclose(metrics["largest_cluster_weight"],
                               ref_metrics["largest_cluster_weight"],
                               rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_particle_clusters_and_metrics_match_jax(weighted):
    rng = np.random.default_rng(3)
    locs = np.concatenate([rng.normal(0.0, 0.05, (60, 2)),
                           rng.normal(1.0, 0.05, (60, 2)),
                           rng.uniform(-3, 4, (5, 2))]).astype(np.float32)
    w = rng.random(len(locs)).astype(np.float32)
    w /= w.sum()
    kw = dict(eps=0.5 if weighted else 0.2, min_particles=5,
              weighted=weighted)
    got = list(qt.particle_clusters(torch.from_numpy(locs),
                                    torch.from_numpy(w), **kw))
    ref = list(qi.particle_clusters(locs, w, **kw))
    assert [g[0] for g in got] == [r[0] for r in ref]
    for (_, m_t), (_, m_j) in zip(got, ref):
        np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(
        qt.weighted_pairwise_distances(torch.from_numpy(locs), w),
        qi.weighted_pairwise_distances(locs, w), rtol=1e-12)
    np.testing.assert_allclose(qt.rescaled_distance_mtx(locs),
                               qi.rescaled_distance_mtx(locs), rtol=1e-12)


def test_clustering_resampler_through_the_eager_route():
    """The updater resamples after the step (``host_side``); both modes
    survive, and each cluster's rows are the secondary resampler's draws
    on that cluster, from the one generator in cluster order."""
    _, tu = _bimodal()
    resampler = qt.ClusteringResampler(eps=0.1)
    tu.resampler = resampler
    assert tu._eager_resample
    locs, log_w = tu.particle_locations, tu.particle_log_weights
    gen_state = tu.state.generator.get_state()
    tu.resample()
    assert tu.resample_count == 1
    # The same draws by hand.
    g = torch.Generator().manual_seed(0)
    g.set_state(gen_state)
    w = torch.exp(log_w - torch.logsumexp(log_w, 0))
    expect = locs.clone()
    for label, mask in qt.particle_clusters(locs, w.numpy(), eps=0.1):
        if label == qt.NOISE:
            continue
        rows = torch.from_numpy(mask.nonzero()[0])
        sub = w.numpy()[mask]
        expect[rows] = resampler.secondary_resampler(
            g, tu.model, locs[rows],
            torch.log(torch.tensor(sub / sub.sum(), dtype=torch.float32)))
    torch.testing.assert_close(tu.particle_locations, expect, rtol=0, atol=0)
    x = tu.particle_locations[:, 0].numpy()
    assert np.sum(np.abs(x - 0.2) < 0.05) > 500
    assert np.sum(np.abs(x - 0.8) < 0.05) > 500
    # An update with a collapsing ESS takes the same route.
    for k in range(10):
        tu.update(k % 2, {"t": np.array([40.0 + k], np.float32)})
    assert tu.resample_count > 1
    assert np.all(np.isfinite(tu.particle_locations.numpy()))


def test_rebit_plots():
    import matplotlib.pyplot as plt

    basis = tt.gell_mann_basis(2)
    prior = tt.GinibreReditDistribution(basis)
    fig = plt.figure()
    try:
        ax = tt.plot_rebit_prior(prior, n_samples=300)
        assert len(ax.collections[0].get_offsets()) == 300
        assert ax.get_xlabel() == basis.labels[1]
        u = qt.SMCUpdater(tt.TomographyModel(basis), 400, prior, seed=0,
                          device="cpu")
        plt.figure()
        ax = tt.plot_rebit_posterior(u, true_state=np.array(
            [0.7071, 0.3, 0.0, 0.2], np.float32))
        assert len(ax.collections[0].get_offsets()) == 400
        assert len(ax.get_lines()) == 3  # disc, estimate, truth
    finally:
        plt.close("all")
    np.testing.assert_allclose(
        tt.rebit_coords(torch.tensor([[0.7, 0.1, 0.0, 0.2]])),
        jt.rebit_coords(np.array([[0.7, 0.1, 0.0, 0.2]], np.float32)),
        rtol=1e-6)
    del fig


def test_progress_bar_version_and_exceptions():
    bar = qt.IPythonProgressBar()
    bar.start(10)
    bar.update(4)
    assert bar._value == 4.0
    bar.finished()
    assert bar._value == 10.0
    bar.description = "SMC"
    assert qt.__version__ == qi.__version__
    assert issubclass(qt.ResamplerError, RuntimeError)
    assert issubclass(qt.ResamplerWarning, Warning)
    from qinfer_tpu_torch._due import due

    assert due.dcite()(len) is len


def test_aux_exports_match_jax():
    assert set(qi.__all__) <= set(qt.__all__)
    assert isinstance(from_reference(qi.ClusteringResampler()),
                      qt.ClusteringResampler)
