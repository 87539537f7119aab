"""The rest of the engine API of the port against the JAX package (CPU):
the ``utils`` helpers, the resampling-divergence record and the eager
resample route, credible regions, marginals, the KDE mesh, the plots,
``sample`` and ``__repr__``; and the four engine-API paths of
``chip_smoke.py`` (``phase_engine_api``) at N = 4096.

Posterior summaries are compared on one bank carried across with
``state_from_numpy`` after updates without resampling, so that no weights
tie across the cut: credible sets, hull vertices and ``in_credible_region``
identical, ``mvee`` at rtol 1e-6, the marginal at rtol 1e-5, the mesh at
rtol 1e-4 (f32 sums in another order and another factorisation of the
kernel), ``_gaussian_kl`` at rtol 1e-10. Whole paths are held by moments
against the JAX updater on the same record, within five joint posterior
standard deviations, as ``test_torch_configs.py`` holds the card's records.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.smc as jsmc
import qinfer_tpu.utils as ju_utils
import qinfer_tpu_torch as qt
import qinfer_tpu_torch.smc as tsmc
from qinfer_tpu_torch import utils as tu_utils
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 4096
CPU = torch.device("cpu")


# -- utils ----------------------------------------------------------------------

def test_outer_product_and_particle_meanfn_match_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(tu_utils.outer_product(torch.from_numpy(v)),
                               np.asarray(ju_utils.outer_product(v)),
                               rtol=1e-6)
    w = rng.random(50).astype(np.float32)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    for fn_t, fn_j in ((None, None), (lambda a: a ** 2, lambda a: a ** 2)):
        np.testing.assert_allclose(
            tu_utils.particle_meanfn(torch.from_numpy(w), torch.from_numpy(x),
                                     fn_t).numpy(),
            np.asarray(ju_utils.particle_meanfn(jnp.asarray(w),
                                                jnp.asarray(x), fn_j)),
            rtol=1e-5)


@pytest.mark.parametrize("d", [2, 3])
def test_mvee_and_ellipsoid_helpers_match_jax(d):
    pts = np.random.default_rng(d).standard_normal((40, d))
    A_t, c_t = tu_utils.mvee(pts, tol=1e-4)
    A_j, c_j = ju_utils.mvee(pts, tol=1e-4)
    np.testing.assert_allclose(A_t, A_j, rtol=1e-6)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-6, atol=1e-12)
    probe = np.random.default_rng(9).standard_normal((200, d)) * 1.5
    np.testing.assert_array_equal(tu_utils.in_ellipsoid(probe, A_t, c_t),
                                  ju_utils.in_ellipsoid(probe, A_j, c_j))
    assert tu_utils.in_ellipsoid(c_t, A_t, c_t) is True
    assert tu_utils.ellipsoid_volume(A_t) == pytest.approx(
        ju_utils.ellipsoid_volume(A_j), rel=1e-12)
    assert tu_utils.ellipsoid_volume(invA=np.linalg.inv(A_t)) == \
        pytest.approx(tu_utils.ellipsoid_volume(A_t), rel=1e-12)
    with pytest.raises(ValueError):
        tu_utils.ellipsoid_volume()


def test_formatting_and_record_helpers_match_jax():
    cases = [(1.234, 0.05), (1234.5, 12.0), (0.000123, 0.0000045),
             (123456.0, 789.0), (5.0, 0.0), (0.0, 0.3), (-42.42, 0.7),
             (9.99e-7, 3e-9)]
    for value, unc in cases:
        assert tu_utils.format_uncertainty(value, unc) == \
            ju_utils.format_uncertainty(value, unc)
    tu_utils.assert_sigfigs_equal(1.2345, 1.2349, sigfigs=3)
    with pytest.raises(AssertionError):
        tu_utils.assert_sigfigs_equal(1.234, 1.334, sigfigs=3)
    np.testing.assert_array_equal(tu_utils.compactspace(2.0, 7),
                                  ju_utils.compactspace(2.0, 7))
    seq = [3, 1, 3, 2, 1, 5]
    assert tu_utils.uniquify(seq) == ju_utils.uniquify(seq) == [3, 1, 2, 5]
    a = np.zeros(4, dtype=[("t", float)])
    b = np.ones(4, dtype=[("n_meas", int), ("w_", float)])
    a["t"] = [1, 2, 3, 4]
    joined = tu_utils.join_struct_arrays([a, b])
    np.testing.assert_array_equal(joined, ju_utils.join_struct_arrays([a, b]))
    sel, rest = tu_utils.split_struct_array(joined, ["t", "w_"])
    sel_j, rest_j = ju_utils.split_struct_array(joined, ["t", "w_"])
    np.testing.assert_array_equal(sel, sel_j)
    np.testing.assert_array_equal(rest, rest_j)
    out = tu_utils.to_shaped_outcomes(np.int64(3))
    assert out.dtype == torch.int32 and out.tolist() == [3]
    assert tu_utils.to_shaped_outcomes([0.5, 1.5]).dtype == torch.float32


# -- resampling divergence and the eager route ----------------------------------

def test_gaussian_kl_matches_jax():
    rng = np.random.default_rng(4)
    for d in (1, 3):
        w0 = rng.random(300)
        w0 /= w0.sum()
        l0 = rng.standard_normal((300, d))
        w1 = np.full(300, 1 / 300)
        l1 = 0.9 * l0 + 0.1 * rng.standard_normal((300, d))
        assert tsmc._gaussian_kl(w0, l0, w1, l1) == pytest.approx(
            jsmc._gaussian_kl(w0, l0, w1, l1), rel=1e-10)


def test_resampling_divergence_recorded():
    """tests/test_round2_fixes.py:71-105 in the port: one divergence per
    resample, the eager batch_update, reset, and None without tracking."""
    model = qt.SimplePrecessionModel()
    prior = qt.UniformDistribution([0.0, 1.0])
    u = qt.SMCUpdater(model, 1000, prior, track_resampling_divergence=True,
                      resample_thresh=1.1, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    for k in range(5):
        u.update(int(rng.integers(2)), {"t": np.array([(9 / 8) ** k])})
    assert u.resample_count == 5 and u.just_resampled
    div = np.asarray(u.resampling_divergences)
    assert len(div) == 5 and np.all(np.isfinite(div))
    assert np.all(div > -1e-6) and np.all(div < 0.5)
    u.batch_update(np.array([0, 1]), {"t": np.array([2.0, 3.0], np.float32)})
    assert len(u.resampling_divergences) == 7
    assert len(u.data_record) == len(u.normalization_record) == 7
    u.reset()
    assert u.resampling_divergences == []
    assert qt.SMCUpdater(model, 100, prior,
                         device="cpu").resampling_divergences is None


def test_eager_route_resamples_at_the_same_update_as_jax():
    """The eager test is n_ess recomputed from the new log-weights: from
    the same bank both packages first resample at the same update, and
    each records that resample's divergence."""
    ts, outcomes = chip_smoke.experiment_record(30, 0)
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), 2000,
                       qi.UniformDistribution([0, 1]), seed=0,
                       track_resampling_divergence=True)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 2000,
                       qt.UniformDistribution([0, 1]), seed=0,
                       track_resampling_divergence=True, device="cpu")
    tu.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, ju.state))
    first = {}
    for k, (t, o) in enumerate(zip(ts, outcomes)):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
        tu.update(int(o), {"t": np.array([t])})
        for name, u in (("jax", ju), ("torch", tu)):
            if u.resample_count and name not in first:
                first[name] = k
        if len(first) == 2:
            break
    assert first["jax"] == first["torch"]
    assert len(ju.resampling_divergences) == len(tu.resampling_divergences) == 1
    assert tu.resampling_divergences[0] == pytest.approx(
        ju.resampling_divergences[0], abs=0.05)


class _HostSide(qt.LiuWestResampler):
    """A resampler that asks for the eager route."""

    host_side = True
    calls = 0

    def __call__(self, *args, **kwargs):
        type(self).calls += 1
        return super().__call__(*args, **kwargs)


def test_host_side_resampler_takes_the_eager_route():
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 500,
                      qt.UniformDistribution([0, 1]), resampler=_HostSide(),
                      resample_thresh=1.1, device="cpu")
    u.batch_update(np.array([0, 1, 1]), {"t": np.array([1.0, 2.0, 3.0])})
    assert _HostSide.calls == u.resample_count == 3
    assert u.resampling_divergences is None
    u.update(0, {"t": np.array([4.0])}, check_for_resample=False)
    assert u.resample_count == 3 and not u.just_resampled


# -- posterior summaries on one carried bank ------------------------------------

@pytest.fixture(scope="module")
def banks():
    """(JAX updater, port updater) on one bank after updates without
    resampling (so the weights differ but for a few f32 ties), for
    MultiCos (D = 2) and SimplePrecession (D = 1)."""
    out = {}
    for name, model_j, box, ep_rows in (
            ("multicos", qi.MultiCosModel(n_terms=2), [[0, 1], [0, 1]],
             [{"ts": [[1.0, 2.0]]}, {"ts": [[3.0, 0.5]]},
              {"ts": [[2.5, 2.5]]}]),
            ("precession", qi.SimplePrecessionModel(), [[0, 1]],
             [{"t": [2.0]}, {"t": [5.0]}, {"t": [7.0]}])):
        ju = qi.SMCUpdater(model_j, 3000, qi.UniformDistribution(box),
                           seed=1, resample_thresh=0.0)
        for k, ep in enumerate(ep_rows):
            ju.update(jnp.int32(k % 2), {f: jnp.asarray(np.asarray(v,
                                                                   np.float32))
                                         for f, v in ep.items()})
        tu = qt.SMCUpdater(from_reference(model_j), 3000,
                           qt.UniformDistribution(box), device="cpu")
        tu.state = state_from_numpy(
            jax.tree_util.tree_map(np.asarray, ju.state))
        out[name] = (ju, tu)
    return out


def _rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("name", ["multicos", "precession"])
@pytest.mark.parametrize("level", [0.5, 0.95])
def test_credible_regions_match_jax(banks, name, level):
    ju, tu = banks[name]
    inside_t, outside_t = tu.est_credible_region(level, return_outside=True)
    inside_j, outside_j = ju.est_credible_region(level, return_outside=True)
    # No tie across the cut: the set is the same whatever order ties take.
    w = np.sort(np.asarray(ju.particle_weights))[::-1]
    assert w[len(inside_j) - 1] != w[len(inside_j)]
    np.testing.assert_array_equal(_rows(inside_t), _rows(inside_j))
    np.testing.assert_array_equal(_rows(outside_t), _rows(outside_j))
    np.testing.assert_array_equal(
        _rows(tu.est_credible_region(level, modelparam_slice=slice(0, 1))),
        _rows(ju.est_credible_region(level, modelparam_slice=slice(0, 1))))
    v_t, s_t = tu.region_est_hull(level)
    v_j, s_j = ju.region_est_hull(level)
    np.testing.assert_array_equal(_rows(v_t), _rows(v_j))
    assert (s_t is None) == (s_j is None)
    if s_t is not None:
        assert s_t.shape == s_j.shape
        A_t, c_t = tu.region_est_ellipsoid(level)
        A_j, c_j = ju.region_est_ellipsoid(level)
        np.testing.assert_allclose(A_t, A_j, rtol=1e-6)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-6)
    rng = np.random.default_rng(2)
    d = inside_j.shape[1]
    probe = rng.random((400, d)).astype(np.float32)
    for method in ("hpd-hull", "hpd-mvee"):
        np.testing.assert_array_equal(
            tu.in_credible_region(probe, level, method=method),
            ju.in_credible_region(probe, level, method=method))
    assert bool(tu.in_credible_region(torch.from_numpy(probe[:1]), level)[0]
                ) == bool(ju.in_credible_region(probe[:1], level)[0])


def test_credible_set_with_tied_weights_is_the_stable_order():
    """After a resample every weight ties: the port keeps the first n_keep
    particles by index (a stable descending sort)."""
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 1000,
                      qt.UniformDistribution([0, 1]), device="cpu")
    region = u.est_credible_region(0.95)
    assert torch.equal(region, u.particle_locations[:region.shape[0]])
    assert abs(region.shape[0] - 950) <= 1


@pytest.mark.parametrize("name", ["multicos", "precession"])
@pytest.mark.parametrize("kw", [{}, {"res": 37}, {"smoothing": 0.02},
                                {"range_min": 0.1, "range_max": 0.8}],
                         ids=["default", "res37", "smoothing", "range"])
def test_posterior_marginal_matches_jax(banks, name, kw):
    ju, tu = banks[name]
    for idx in range(tu.model.n_modelparams):
        xs_t, h_t = tu.posterior_marginal(idx, **kw)
        xs_j, h_j = ju.posterior_marginal(idx, **kw)
        np.testing.assert_array_equal(xs_t.numpy(), xs_j)
        np.testing.assert_allclose(h_t.numpy(), h_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(h_j).max())


def test_posterior_marginal_closes_the_last_bin():
    """A particle at hi falls in the last bin, one at lo in the first, as
    np.histogram bins them; the density integrates to 1."""
    locs = torch.tensor([[0.0], [0.25], [0.5], [1.0]])
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 4,
                      qt.UniformDistribution([0, 1]), device="cpu")
    u.state = dataclasses.replace(u.state, particle_locations=locs)
    xs, hist = u.posterior_marginal(res=4)
    np.testing.assert_allclose(hist.numpy(), [1.0, 1.0, 1.0, 1.0])
    ref, _ = np.histogram(locs.numpy()[:, 0], bins=4, range=(0.0, 1.0),
                          weights=np.full(4, 0.25), density=True)
    np.testing.assert_allclose(hist.numpy(), ref)


def test_posterior_mesh_matches_jax(banks):
    ju, tu = banks["multicos"]
    mx_t, my_t, z_t = tu.posterior_mesh(res1=40, res2=30)
    mx_j, my_j, z_j = ju.posterior_mesh(res1=40, res2=30)
    assert z_t.shape == (30, 40)
    np.testing.assert_array_equal(mx_t.numpy(), mx_j)
    np.testing.assert_array_equal(my_t.numpy(), my_j)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-4,
                               atol=1e-6 * np.abs(z_j).max())
    _, _, z1 = tu.posterior_mesh(1, 0, res1=20, res2=25, smoothing=0.05)
    _, _, z1_j = ju.posterior_mesh(1, 0, res1=20, res2=25, smoothing=0.05)
    np.testing.assert_allclose(z1.numpy(), z1_j, rtol=1e-4,
                               atol=1e-6 * np.abs(z1_j).max())


def test_plots_under_agg(banks):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, tu = banks["multicos"]
    line = tu.plot_posterior_marginal(1, res=30, true_model=np.array([0.3,
                                                                      0.6]))
    assert len(line) == 1 and len(line[0].get_xdata()) == 30
    assert plt.gca().get_xlabel() == "omega_1"
    plt.figure()
    assert tu.plot_posterior_contour(res1=20, res2=20) is not None
    plt.figure()
    im = tu.plot_covariance(corr=True)
    assert im.get_array().shape == (2, 2)
    plt.close("all")


def test_sample_chi_square_on_four_particles():
    from scipy.stats import chisquare

    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 4,
                      qt.UniformDistribution([0, 1]), device="cpu", seed=3)
    p = np.array([0.1, 0.2, 0.3, 0.4])
    locs = torch.tensor([[0.1], [0.2], [0.3], [0.4]])
    u.state = dataclasses.replace(
        u.state, particle_locations=locs,
        particle_log_weights=torch.log(torch.tensor(p, dtype=torch.float32)))
    before = u.state.generator.get_state()
    draws = u.sample(n=20000)
    assert not torch.equal(before, u.state.generator.get_state())
    assert draws.shape == (20000, 1)
    counts = np.array([(draws[:, 0] == locs[i, 0]).sum().item()
                       for i in range(4)])
    assert counts.sum() == 20000
    assert chisquare(counts, 20000 * p).pvalue > 1e-3
    g = torch.Generator().manual_seed(11)
    a = u.sample(torch.Generator().manual_seed(11), n=50)
    assert torch.equal(a, u.sample(g, n=50))


def test_repr():
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 64,
                      qt.UniformDistribution([0, 1]), device="cpu")
    j = qi.SMCUpdater(qi.SimplePrecessionModel(), 64,
                      qi.UniformDistribution([0, 1]))
    assert repr(u) == repr(j) == (
        "SMCUpdater(model=SimplePrecessionModel, n_particles=64, "
        "resample_count=0)")


# -- the four engine-API paths of chip_smoke.py at N = 4096 ---------------------

def _assert_means_agree(tu, ju):
    mean_t, cov_t = tu.est_mean().numpy(), tu.est_covariance_mtx().numpy()
    mean_j = np.asarray(ju.est_mean())
    var_t = np.diag(cov_t)
    var_j = np.diag(np.asarray(ju.est_covariance_mtx()))
    assert np.all(np.abs(mean_t - mean_j)
                  < 5 * np.sqrt(var_t + var_j) + 1e-6), (mean_t, mean_j)


def _jax_flagship_updates(ju):
    ts, outcomes = chip_smoke.experiment_record(chip_smoke.N_EXP, 0)
    for t, o in zip(ts, outcomes):
        ju.update(jnp.int32(o), {"t": jnp.asarray([t])})
    return ts


def test_flagship_bcrb_path():
    w = chip_smoke.bcrb_window(N, 1, CPU)
    assert chip_smoke.bcrb_gate(w), w
    ju = qi.SMCUpdaterBCRB(qi.SimplePrecessionModel(), N,
                           qi.UniformDistribution([0, 1]), seed=0,
                           zero_weight_policy="reset")
    _jax_flagship_updates(ju)
    assert float(ju.current_bim[0, 0]) / w["sum_t2"] == pytest.approx(
        w["bim_ratio"], rel=chip_smoke.BCRB_RTOL)
    _assert_means_agree(w["updater"], ju)


def test_flagship_track_rsd_path():
    w = chip_smoke.track_rsd_window(N, 2, CPU)
    assert chip_smoke.track_rsd_gate(w), w
    ju = qi.SMCUpdater(qi.SimplePrecessionModel(), N,
                       qi.UniformDistribution([0, 1]), seed=0,
                       zero_weight_policy="reset",
                       track_resampling_divergence=True)
    ts, outcomes = chip_smoke.experiment_record(chip_smoke.N_EXP, 0)
    ju.batch_update(jnp.asarray(outcomes), {"t": jnp.asarray(ts)})
    assert len(ju.resampling_divergences) == ju.resample_count > 0
    _assert_means_agree(w["updater"], ju)


def test_mixed_ale_path():
    w = chip_smoke.mixed_ale_window(N, 3, CPU)
    assert chip_smoke.mixed_ale_gate(w), w
    assert 0 < w["approx_updates"] < chip_smoke.N_EXP
    ale = qt.ALEApproximateModel()
    assert all(ale.min_samp <= s <= ale.max_samp
               for s in w["approx_samples"])
    ju = qi.MixedApproximateSMCUpdater(
        qi.SimplePrecessionModel(),
        qi.ALEApproximateModel(simulator=qi.SimplePrecessionModel()), N,
        qi.UniformDistribution([0, 1]), mixture_thresh=chip_smoke.ALE_THRESH,
        seed=0, zero_weight_policy="reset")
    _jax_flagship_updates(ju)
    assert ju._sharpened
    _assert_means_agree(w["updater"], ju)


def test_posterior_summaries_path():
    cfg = chip_smoke.config4_multicos2()
    _, _, _, _, tu = chip_smoke._config_window(cfg, 4, CPU, n=N)
    s = chip_smoke.posterior_summaries(tu, cfg.truth, CPU)
    assert chip_smoke.summaries_gate(s), s
    assert s["credible_size"] == s["host_credible_size"]
    assert set(s["seconds"]) == {
        "est_credible_region", "region_est_hull", "region_est_ellipsoid",
        "in_credible_region_hull", "in_credible_region_mvee",
        "posterior_marginal", "posterior_mesh", "sample"}
    ju = qi.SMCUpdater(qi.MultiCosModel(n_terms=2), N,
                       qi.UniformDistribution(cfg.prior), seed=0,
                       zero_weight_policy="reset")
    ju.batch_update(jnp.asarray(cfg.outcomes),
                    {k: jnp.asarray(v) for k, v in cfg.expparams.items()})
    _assert_means_agree(tu, ju)
    assert bool(ju.in_credible_region(np.array([cfg.truth]), level=0.99)[0])
