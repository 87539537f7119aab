"""Port parity for B1's likelihood-tile zoo (CPU).

The twelve cases of ``tests/test_pallas_ops.py``'s zoo, and the Born tile
at 16 columns (one update of two-qubit binomial tomography). For each, the
port's model builds the same ``scalars`` array as the JAX package's, and
the port's plain version of ``fused_bayes_update`` on those scalars is held
against the JAX Pallas kernel in interpret mode, on the same seeded numpy
bank (a uniform box, or Ginibre states for tomography). The port's fused
route is also held against its own unfused route, with the tolerances of
``test_pallas_ops.py``.

Tolerances against JAX: log_norm atol 2e-4, ESS rtol 1e-3, log-weights
atol 1e-4 plus the likelihood's conditioning term and never above 2e-3.
The two frameworks round cos, exp and log differently by an ulp for a few
percent of arguments, and the tile's log(p1) and log(1 − p1) turn an
absolute error δ ≤ 2⁻²¹ in p1 into k·δ/p1 + (n−k)·δ/(1−p1) in log L
(two-outcome tiles: n = 1, k = outcome). Particles where that term would
pass 1.9e-3, and the tail below max − 20, are compared on the scale of
normalized weights (atol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu.tomography as jt
import qinfer_tpu_torch as qt
from qinfer_tpu.ops import fused_update as jfu
from qinfer_tpu_torch.interop import from_reference
from qinfer_tpu_torch.interop import state_from_numpy
from qinfer_tpu_torch.ops import fused_update as tfu

torch.set_num_threads(2)

LN_ATOL, LW_ATOL, ESS_RTOL = 2e-4, 2e-3, 1e-3
_DELTA = 2.0 ** -21


def _cos2(x):
    return np.cos(0.5 * x) ** 2


def _rb_surv(m, decay, A, B):
    return np.clip(A * np.clip(decay, 1e-20, 1.0) ** m + B, 0.0, 1.0)


# name, JAX model, prior box, outcome, expparams, f64 Pr(1)(locs) —
# the cases of test_pallas_ops.py's zoo less the two tomography ones.
ZOO = [
    ("multicos", qi.MultiCosModel(n_terms=2), [[0, 1], [0, 1]], 1,
     {"ts": np.array([[1.3, 0.4]], np.float32)},
     lambda x: 1 - _cos2(x @ np.array([1.3, 0.4], np.float32))),
    ("known_t2", qi.KnownT2PrecessionModel(t2=30.0), [[0, 1]], 0,
     {"t": np.array([7.0], np.float32)},
     lambda x: 1 - (np.exp(-7 / 30) * _cos2(7 * x[:, 0])
                    + 0.5 * (1 - np.exp(-7 / 30)))),
    ("rb", qi.rb.RandomizedBenchmarkingModel(),
     [[0.8, 1.0], [0.2, 0.5], [0.3, 0.5]], 1,
     {"m": np.array([32], np.int32)},
     lambda x: 1 - _rb_surv(32, x[:, 0], x[:, 1], x[:, 2])),
    ("binomial_precession", qi.BinomialModel(qi.SimplePrecessionModel()),
     [[0, 1]], 11,
     {"t": np.array([2.0], np.float32), "n_meas": np.array([40], np.int32)},
     lambda x: 1 - _cos2(2.0 * x[:, 0])),
    ("binomial_rb", qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel()),
     [[0.8, 1.0], [0.2, 0.5], [0.3, 0.5]], 210,
     {"m": np.array([16], np.int32), "n_meas": np.array([300], np.int32)},
     lambda x: 1 - _rb_surv(16, x[:, 0], x[:, 1], x[:, 2])),
    ("rb_interleaved", qi.rb.RandomizedBenchmarkingModel(interleaved=True),
     [[0.8, 1.0], [0.8, 1.0], [0.2, 0.5], [0.3, 0.5]], 1,
     {"m": np.array([24], np.int32), "reference": np.array([0], np.int32)},
     lambda x: 1 - _rb_surv(24, x[:, 0] * x[:, 1], x[:, 2], x[:, 3])),
    ("rb_interleaved_ref",
     qi.rb.RandomizedBenchmarkingModel(interleaved=True),
     [[0.8, 1.0], [0.8, 1.0], [0.2, 0.5], [0.3, 0.5]], 0,
     {"m": np.array([24], np.int32), "reference": np.array([1], np.int32)},
     lambda x: 1 - _rb_surv(24, x[:, 1], x[:, 2], x[:, 3])),
    ("inversion", qi.SimpleInversionModel(), [[0, 1]], 0,
     {"w_": np.array([0.3], np.float32), "t": np.array([4.0], np.float32)},
     lambda x: 1 - _cos2((x[:, 0] - np.float32(0.3)) * 4.0)),
    ("coin", qi.CoinModel(), [[0, 1]], 1,
     {"dummy": np.array([0.0], np.float32)}, lambda x: x[:, 0]),
    ("noisy_coin", qi.NoisyCoinModel(), [[0, 1]], 0,
     {"alpha": np.array([0.9], np.float32),
      "beta": np.array([0.1], np.float32)},
     lambda x: 1 - (0.9 * (1 - x[:, 0]) + 0.1 * x[:, 0])),
]


def _ginibre(basis, eps=False):
    """Bank maker: Ginibre state coordinates drawn with numpy (and a
    diffusion rate ε ~ U[0, 0.05] as a last column)."""

    def make(n, rng):
        d = basis.dim
        g = (rng.standard_normal((n, d, d))
             + 1j * rng.standard_normal((n, d, d)))
        rho = g @ g.conj().transpose(0, 2, 1)
        rho = rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]
        x = np.asarray(basis.state_to_modelparams(rho.astype(np.complex64)))
        if eps:
            x = np.concatenate([x, 0.05 * rng.random((n, 1))], axis=1)
        return x.astype(np.float32)

    return make


def _born(e):
    return lambda x: np.clip(x[:, :len(e)] @ e.astype(np.float64), 0, 1)


_P1, _P2 = jt.pauli_basis(1), jt.pauli_basis(2)
_E4 = np.array([1, 1, 0, 0], np.float32) / np.float32(2 * np.sqrt(2))
# |a⟩⟨a| ⊗ |b⟩⟨b| for two fixed pure states.
_A = np.array([0.6, 0.8j], np.complex64)
_B = np.array([0.8, -0.36 + 0.48j], np.complex64)
_E16 = np.array(_P2.state_to_modelparams(np.kron(
    np.outer(_A, _A.conj()), np.outer(_B, _B.conj()))[None]))[0]
# test_pallas_ops.py:281-286, and one binomial update at 16 columns.
ZOO += [
    ("tomography", jt.TomographyModel(_P1), _ginibre(_P1), 1,
     {"meas": _E4[None]}, _born(_E4)),
    ("diffusive_tomography", jt.DiffusiveTomographyModel(_P1),
     _ginibre(_P1, eps=True), 1,
     {"meas": _E4[None], "t": np.array([1.0], np.float32)}, _born(_E4)),
    ("binomial_tomography_2q", qi.BinomialModel(jt.TomographyModel(_P2)),
     _ginibre(_P2), 31,
     {"meas": _E16[None], "n_meas": np.array([50], np.int32)}, _born(_E16)),
]
IDS = [c[0] for c in ZOO]


def _bank(box, n, seed):
    """(locations, normalized log-weights): a uniform box, or the bank
    maker of a tomography case."""
    rng = np.random.default_rng(seed)
    if callable(box):
        locs = box(n, rng)
    else:
        box = np.asarray(box, np.float64)
        locs = (box[:, 0] + (box[:, 1] - box[:, 0])
                * rng.random((n, len(box)))).astype(np.float32)
    lw = np.log(rng.random(n))
    lw = (lw - np.log(np.sum(np.exp(lw)))).astype(np.float32)
    return locs, lw


def _conditioning(case, locs):
    """δ·(k/p1 + (n−k)/(1−p1)) from the f64 Pr(1)."""
    _, model, _, outcome, ep, pr1 = case
    p1 = np.clip(pr1(locs.astype(np.float64)), 1e-300, 1.0)
    n = float(ep["n_meas"][0]) if "n_meas" in ep else 1.0
    k = float(outcome)
    with np.errstate(divide="ignore"):
        return _DELTA * (k / p1 + (n - k) / np.maximum(1.0 - p1, 1e-300))


def assert_log_weights_close(t, j, cond):
    t, j = np.asarray(t), np.asarray(j)
    live = (j > j.max() - 20.0) & (cond <= LW_ATOL - 1e-4)
    # The log-space comparison covers the posterior's mass.
    assert np.exp(j[live]).sum() > 0.99
    assert np.all(np.abs(t[live] - j[live]) <= 1e-4 + cond[live])
    np.testing.assert_allclose(np.exp(t[~live]), np.exp(j[~live]), atol=1e-9)


def _jax_scalars(model, outcome, locs, ep):
    """The scalars the JAX model's fused_update builds."""
    from jax.scipy.special import gammaln

    if isinstance(model, qi.BinomialModel):
        _, tail, _ = model.underlying_model._fused_pr1_parts(
            jnp.asarray(locs), ep)
        n = jnp.float32(ep["n_meas"][0])
        k = jnp.float32(outcome)
        log_c = gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)
        return np.asarray(jnp.concatenate([jnp.stack([k, n, log_c]), tail]))
    _, tail, _ = model._fused_pr1_parts(jnp.asarray(locs), ep)
    return np.asarray(jnp.concatenate([jnp.float32([outcome]), tail]))


def _jax_tile(model, locs, ep):
    if isinstance(model, qi.BinomialModel):
        pr1, _, _ = model.underlying_model._fused_pr1_parts(locs, ep)
        return jfu.binomial_tile(pr1)
    pr1, _, _ = model._fused_pr1_parts(locs, ep)
    return jfu.two_outcome_tile(pr1)


@pytest.mark.parametrize("n", [257, 2048])
@pytest.mark.parametrize("case", ZOO, ids=IDS)
def test_zoo_tile_matches_pallas_interpret(case, n):
    _tile_matches_pallas_interpret(case, n)


@pytest.mark.parametrize("case", ZOO[-3:], ids=IDS[-3:])
def test_born_tile_matches_pallas_interpret_at_16384(case):
    _tile_matches_pallas_interpret(case, 16384)


def _tile_matches_pallas_interpret(case, n):
    name, model_j, box, outcome, ep, _ = case
    model_t = from_reference(model_j)
    locs, lw = _bank(box, n, n + len(name))
    tile_t, scal_t, cols_t = model_t.fused_spec(
        outcome, torch.from_numpy(locs),
        {k: torch.from_numpy(v) for k, v in ep.items()})
    scal = _jax_scalars(model_j, outcome, locs, ep)
    # Same layout, same values (log C by lgamma in both: within an ulp).
    np.testing.assert_allclose(scal_t.numpy(), scal, rtol=1e-6, atol=0)
    assert tile_t.kernel_tile is not None  # a CUDA functor exists

    j_lw, j_ln, j_ess = jfu.fused_bayes_update(
        _jax_tile(model_j, jnp.asarray(locs), ep), jnp.asarray(scal),
        jnp.asarray(lw), tuple(jnp.asarray(locs[:, d])
                               for d in range(locs.shape[1])),
        tile=1024, interpret=True)
    launches = tfu.fused_bayes_update.launches
    t_lw, t_ln, t_ess = tfu.fused_bayes_update(
        tile_t, torch.tensor(scal), torch.from_numpy(lw), cols_t)
    assert tfu.fused_bayes_update.launches == launches  # CPU: plain version
    assert_log_weights_close(t_lw.numpy(), j_lw, _conditioning(case, locs))
    np.testing.assert_allclose(float(t_ln), float(j_ln), atol=LN_ATOL)
    np.testing.assert_allclose(float(t_ess), float(j_ess), rtol=ESS_RTOL)


@pytest.mark.parametrize("case", ZOO, ids=IDS)
def test_model_fused_update_matches_jax(case):
    """Model.fused_update end to end on both sides."""
    name, model_j, box, outcome, ep, _ = case
    locs, lw = _bank(box, 1024, 5)
    j = model_j.fused_update(jnp.int32(outcome), jnp.asarray(lw),
                             jnp.asarray(locs),
                             {k: jnp.asarray(v) for k, v in ep.items()},
                             interpret=True)
    t = from_reference(model_j).fused_update(
        outcome, torch.from_numpy(lw), torch.from_numpy(locs),
        {k: torch.from_numpy(v) for k, v in ep.items()})
    assert_log_weights_close(t[0].numpy(), j[0], _conditioning(case, locs))
    np.testing.assert_allclose(float(t[1]), float(j[1]), atol=LN_ATOL)
    np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=ESS_RTOL)


@pytest.mark.parametrize("case", ZOO, ids=IDS)
def test_fused_route_matches_unfused_route(case):
    """The port's fused route against its own unfused route through
    smc_update_step, with test_pallas_ops.py's tolerances."""
    name, model_j, box, outcome, ep, _ = case
    model = from_reference(model_j)
    assert model.fused_update_supported, name
    locs, _ = _bank(box, 2048, 3)
    n = locs.shape[0]
    st = state_from_numpy({
        "particle_locations": locs,
        "particle_log_weights": np.full(n, -np.log(n), np.float32),
        "n_resamples": 0, "min_n_ess": float(n), "log_total_likelihood": 0.0,
        "just_resampled": False, "n_zero_weight_events": 0})
    ep_t = {k: torch.from_numpy(v) for k, v in ep.items()}
    out = {}
    for fused in (False, True):
        cfg = qt.SMCConfig(zero_weight_policy="reset", resample_thresh=-1.0,
                           use_fused_update=fused)
        out[fused] = qt.smc_update_step(model, qt.LiuWestResampler(), cfg,
                                        st, torch.tensor(outcome), ep_t)
    (st_x, ln_x), (st_f, ln_f) = out[False], out[True]
    np.testing.assert_allclose(float(ln_x), float(ln_f), atol=LN_ATOL)
    np.testing.assert_allclose(st_x.particle_log_weights.numpy(),
                               st_f.particle_log_weights.numpy(),
                               atol=LW_ATOL)
    np.testing.assert_allclose(float(st_x.min_n_ess), float(st_f.min_n_ess),
                               rtol=ESS_RTOL)


def test_tiles_are_found_by_value():
    """Factory tiles are equal values, so each call finds its functor."""
    assert tfu.make_multicos_pr1(2) == tfu.make_multicos_pr1(2)
    assert tfu.make_known_t2_pr1(30.0).consts == (30.0,)
    assert tfu.make_born_pr1(16) == tfu.make_born_pr1(16)
    specs = {tfu.two_outcome_tile(p).kernel_tile[1] for p in (
        tfu.precession_pr1, tfu.make_multicos_pr1(3),
        tfu.make_known_t2_pr1(5.0), tfu.rb_pr1, tfu.rb_interleaved_pr1,
        tfu.inversion_pr1, tfu.coin_pr1, tfu.noisy_coin_pr1,
        tfu.make_born_pr1(4))}
    assert specs == set(range(9))
    assert tfu.binomial_tile(tfu.rb_pr1).kernel_tile == (1, 3, ())


def test_cuda_route_raises_for_missing_functor_and_wide_tiles():
    """On the CUDA route a tile with no functor, or with more than
    MAX_COLS = 64 columns, raises before any launch (every built-in
    functor takes that many); the CPU route runs the plain version."""
    model = qt.MultiCosModel(n_terms=tfu.MAX_COLS + 1)
    locs = torch.rand(64, model.n_modelparams)
    ep = {"ts": torch.rand(1, model.n_modelparams)}
    tile, scal, cols = model.fused_spec(1, locs, ep)
    lw = torch.full((64,), -float(np.log(64.0)))
    wide_msg = f"at most {tfu.MAX_COLS} parameter columns"
    with pytest.raises(ValueError, match=wide_msg):
        tfu._fused_update_cuda(tile, scal, lw, cols)
    assert torch.isfinite(model.fused_update(1, lw, locs, ep)[0]).all()
    wide = torch.rand(64, tfu.MAX_COLS + 1)
    born = tfu.two_outcome_tile(tfu.make_born_pr1(tfu.MAX_COLS + 1))
    with pytest.raises(ValueError, match=wide_msg):
        tfu._fused_update_cuda(born, torch.rand(tfu.MAX_COLS + 2), lw,
                               tuple(wide.T))
    stray = tfu.binomial_tile(lambda scalars, off, x: x)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        tfu._fused_update_cuda(stray, scal[:4], lw, (locs[:, 0],))
