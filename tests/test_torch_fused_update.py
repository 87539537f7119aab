"""Port parity for kernel B1, the fused Bayes update (CPU).

The port's plain version of ``fused_bayes_update`` is held against the JAX
package's Pallas kernel in interpret mode and against its XLA engine path,
on the same seeded numpy inputs. Tolerances: atol 1e-4 on log-weights above
max − 20, atol 1e-5 on log_norm, rtol 1e-3 on ESS. Below max − 20 the
weights are compared on the weight scale.

Both frameworks compute cos faithfully (under 0.6 ulp against f64) but
round differently for about 5% of arguments, and log(1 − c²) turns one ulp
of c into about 2⁻²³/pr; the two-outcome tile's 1 − (1 − c²) loses up to an
ulp of 1 the same way. So a particle whose likelihood pr is small gets the
conditioning term 2⁻²²/pr on top of the 1e-4 (pr from the f64 likelihood).
Where pr < 2⁻²⁰ the tile's 1 − (1 − c²) cannot resolve it at all (the
engine's log(c²) form can), so those particles, like the tail below
max − 20, are compared on the scale of normalized weights (1e-9 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.ops import fused_update as jfu
from qinfer_tpu.smc import SMCConfig as JConfig
from qinfer_tpu.smc import smc_update_step as j_step
from qinfer_tpu_torch import _build
from qinfer_tpu_torch.interop import state_from_numpy
from qinfer_tpu_torch.ops import fused_update as tfu

torch.set_num_threads(2)

LW_ATOL, LN_ATOL, ESS_RTOL = 1e-4, 1e-5, 1e-3


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    omega = rng.random(n).astype(np.float32)
    lw = np.log(rng.random(n)).astype(np.float32)
    lw = (lw - np.log(np.sum(np.exp(lw.astype(np.float64))))).astype(
        np.float32)
    return omega, lw


def _pr64(omega, t, outcome):
    """f64 likelihood of each particle."""
    c2 = np.cos(0.5 * np.asarray(omega, np.float64) * t) ** 2
    return c2 if outcome == 0 else 1.0 - c2


def assert_log_weights_close(t, j, pr):
    t, j = np.asarray(t), np.asarray(j)
    live = (j > j.max() - 20.0) & (pr >= 2.0 ** -20)
    tol = LW_ATOL + 2.0 ** -22 / pr[live]
    assert np.all(np.abs(t[live] - j[live]) <= tol)
    np.testing.assert_allclose(np.exp(t[~live]), np.exp(j[~live]), atol=1e-9)


CASES = [(n, outcome, t) for n in (257, 10_000)
         for outcome, t in ((0, 2.0), (1, 17.3), (1, 2.0), (0, 17.3))]


@pytest.mark.parametrize("n,outcome,t", CASES)
def test_fused_update_matches_pallas_interpret(n, outcome, t):
    omega, lw = _inputs(n, n + outcome)
    scal = np.array([outcome, t], np.float32)
    j_lw, j_ln, j_ess = jfu.fused_bayes_update(
        jfu.two_outcome_tile(jfu.precession_pr1), jnp.asarray(scal),
        jnp.asarray(lw), (jnp.asarray(omega),), tile=2048, interpret=True,
    )
    launches = tfu.fused_bayes_update.launches
    t_lw, t_ln, t_ess = tfu.fused_bayes_update(
        tfu.two_outcome_tile(tfu.precession_pr1), torch.from_numpy(scal),
        torch.from_numpy(lw), (torch.from_numpy(omega),),
    )
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert tfu.fused_bayes_update.launches == launches
    assert_log_weights_close(t_lw.numpy(), j_lw, _pr64(omega, t, outcome))
    np.testing.assert_allclose(float(t_ln), float(j_ln), atol=LN_ATOL)
    np.testing.assert_allclose(float(t_ess), float(j_ess), rtol=ESS_RTOL)


@pytest.mark.parametrize("n", [257, 10_000])
def test_return_stats_matches_pallas_interpret(n):
    omega, lw = _inputs(n, 3)
    scal = np.array([1.0, 5.0], np.float32)
    j = jfu.fused_bayes_update(
        jfu.two_outcome_tile(jfu.precession_pr1), jnp.asarray(scal),
        jnp.asarray(lw), (jnp.asarray(omega),), tile=2048, interpret=True,
        return_stats=True,
    )
    t = tfu.fused_bayes_update(
        tfu.two_outcome_tile(tfu.precession_pr1), torch.from_numpy(scal),
        torch.from_numpy(lw), (torch.from_numpy(omega),), return_stats=True,
    )
    assert len(t) == 3
    assert_log_weights_close(t[0].numpy(), j[0], _pr64(omega, 5.0, 1))
    np.testing.assert_allclose(float(t[1]), float(j[1]), atol=LN_ATOL)
    np.testing.assert_allclose(float(t[2]), float(j[2]), atol=LN_ATOL)


@pytest.mark.parametrize("n,outcome,t", CASES)
def test_fused_route_matches_jax_xla_path(n, outcome, t):
    """The port's fused route through smc_update_step against the JAX
    engine's unfused XLA path (log1p form) on the same bank."""
    model_j = qi.SimplePrecessionModel()
    st_j = qi.init_smc_state(jax.random.PRNGKey(n), model_j, n,
                             qi.UniformDistribution([0.0, 1.0]))
    cfg_j = JConfig(zero_weight_policy="reset", use_fused_update=False,
                    resample_thresh=-1.0)
    ep = np.array([t], np.float32)
    st_j2, ln_j = j_step(model_j, qi.LiuWestResampler(), cfg_j, st_j,
                         jnp.int32(outcome), {"t": jnp.asarray(ep)})

    st_t = state_from_numpy(jax.tree_util.tree_map(np.asarray, st_j))
    cfg_t = qt.SMCConfig(zero_weight_policy="reset", use_fused_update=True,
                         resample_thresh=-1.0)
    st_t2, ln_t = qt.smc_update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(), cfg_t, st_t,
        torch.tensor(outcome), {"t": torch.from_numpy(ep)})
    assert_log_weights_close(
        st_t2.particle_log_weights.numpy(), st_j2.particle_log_weights,
        _pr64(np.asarray(st_j.particle_locations)[:, 0], t, outcome))
    np.testing.assert_allclose(float(ln_t), float(ln_j), atol=LN_ATOL)
    np.testing.assert_allclose(float(st_t2.min_n_ess), float(st_j2.min_n_ess),
                               rtol=ESS_RTOL)


def test_model_fused_update_matches_jax():
    omega, lw = _inputs(512, 9)
    ep_t = {"t": torch.tensor([3.0])}
    t_out = qt.SimplePrecessionModel().fused_update(
        1, torch.from_numpy(lw), torch.from_numpy(omega)[:, None], ep_t)
    j_out = qi.SimplePrecessionModel().fused_update(
        jnp.int32(1), jnp.asarray(lw), jnp.asarray(omega)[:, None],
        {"t": jnp.array([3.0], jnp.float32)}, interpret=True)
    assert_log_weights_close(t_out[0].numpy(), j_out[0],
                             _pr64(omega, 3.0, 1))
    np.testing.assert_allclose(float(t_out[1]), float(j_out[1]), atol=LN_ATOL)
    np.testing.assert_allclose(float(t_out[2]), float(j_out[2]),
                               rtol=ESS_RTOL)


def test_fused_update_rejects_multi_experiment():
    lw = torch.full((256,), -float(np.log(256.0)))
    locs = torch.linspace(0.0, 1.0, 256)[:, None]
    with pytest.raises(ValueError, match="E == 1"):
        qt.SimplePrecessionModel().fused_update(
            1, lw, locs, {"t": torch.tensor([1.0, 2.0])})


def test_tile_without_cuda_functor_raises():
    """A tile with no CUDA instantiation raises instead of falling back."""
    tile = tfu.two_outcome_tile(lambda scal, off, x: x)
    assert tile.kernel_tile is None
    assert tfu.two_outcome_tile(tfu.precession_pr1).kernel_tile == 0
    x = torch.rand(64)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        tfu._fused_update_cuda(tile, torch.tensor([1.0]), x, (x,))


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises; nothing falls back to the plain
    version."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
    finally:
        _build.library.cache_clear()


def test_check_raises_on_cuda_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "qt_expand")
