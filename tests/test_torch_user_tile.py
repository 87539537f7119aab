"""B1 on a model's own pr1 (CPU, N = 4096).

The user model is ``chip_smoke.LostVisibilityModel``, precession with lost
visibility: Pr(1) = v·(1 − cos²(ωt/2)) + (1 − v)/2 over (ω, v), written
outside the package as a user writes one, with its torch pr1 and that
pr1's CUDA functor (``chip_smoke.LOST_VISIBILITY_SOURCE``). Its JAX twin
below is a ``register_static`` dataclass subclass of
``qi.FiniteOutcomeModel`` whose ``_fused_pr1_parts`` hands the Pallas
kernel the same pr1 in ``jnp``, as ``tests/test_pallas_ops.py`` defines its
subclasses.

- The port's CPU route (the plain version) against the JAX package's
  Pallas kernel in interpret mode, two-outcome and binomial, at the
  tolerance of ``test_torch_fused_tiles.py::
  test_zoo_tile_matches_pallas_interpret``: log_norm atol 2e-4, ESS rtol
  1e-3, log-weights atol 1e-4 plus the likelihood's conditioning term
  δ·(k/p1 + (n−k)/(1−p1)), δ = 2⁻²¹ (an ulp of cos, exp or log that the two
  frameworks round apart, through log p1 and log(1 − p1)).
- A short ``batch_update`` in both packages with ``use_fused_update=True``
  from the same initial cloud, compared by moments (five joint posterior
  standard deviations, as ``test_torch_configs.py``).
- The column route's plain version (the pr1 evaluated into one column, the
  same composition over ``GivenPr1``) bit-equal to the user tile's.
- The user library's translation unit and cache key, and its build
  raising without ``nvcc``, with no fallback.
- A census: every fused model the port ships has a built-in functor.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_tiles import (ESS_RTOL, LN_ATOL,
                                    assert_log_weights_close)

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.models.base import expparams_field
from qinfer_tpu.ops import fused_update as jfu
from qinfer_tpu_torch import _build
from qinfer_tpu_torch.interop import state_from_numpy
from qinfer_tpu_torch.ops import fused_update as tfu

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N = 4096
_DELTA = 2.0 ** -21


def _jax_pr1(scal_ref, off, omega, v):
    c = jnp.cos(0.5 * omega * scal_ref[off])
    return v * (1.0 - c * c) + 0.5 * (1.0 - v)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class JLostVisibilityModel(qi.FiniteOutcomeModel):
    """The JAX twin of ``chip_smoke.LostVisibilityModel``."""

    @property
    def n_modelparams(self):
        return 2

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def are_models_valid(self, modelparams):
        v = modelparams[:, 1]
        return (modelparams[:, 0] >= 0.0) & (v >= 0.0) & (v <= 1.0)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, jnp.array([0.0, 0.0]),
                        jnp.array([jnp.inf, 1.0]))

    def _t(self, expparams):
        return jnp.asarray(expparams_field(expparams, "t"),
                           jnp.float32).reshape(-1)

    def pr0(self, modelparams, expparams):
        t = self._t(expparams)
        return 1.0 - _jax_pr1(t[None, None, :], 0, modelparams[:, :1],
                              modelparams[:, 1:])

    def _fused_pr1_parts(self, modelparams, expparams):
        return (_jax_pr1, self._t(expparams)[:1],
                (modelparams[:, 0], modelparams[:, 1]))


# (name, port model, JAX model, outcome, expparams)
CASES = [
    ("two_outcome", chip_smoke.LostVisibilityModel(), JLostVisibilityModel(),
     1, {"t": np.array([7.3], np.float32)}),
    ("two_outcome_0", chip_smoke.LostVisibilityModel(),
     JLostVisibilityModel(), 0, {"t": np.array([2.0], np.float32)}),
    ("binomial", qt.BinomialModel(chip_smoke.LostVisibilityModel()),
     qi.BinomialModel(JLostVisibilityModel()), 27,
     {"t": np.array([3.1], np.float32), "n_meas": np.array([40], np.int32)}),
]
IDS = [c[0] for c in CASES]


def _bank(n, seed):
    """(locations (n, 2) in the user prior's box, normalized log-weights)."""
    rng = np.random.default_rng(seed)
    box = np.asarray(chip_smoke.USER_PRIOR, np.float64)
    locs = (box[:, 0] + (box[:, 1] - box[:, 0])
            * rng.random((n, 2))).astype(np.float32)
    lw = np.log(rng.random(n))
    return locs, (lw - np.log(np.sum(np.exp(lw)))).astype(np.float32)


def _conditioning(outcome, ep, locs):
    p1 = np.clip(chip_smoke.user_pr1_f64(locs[:, 0].astype(np.float64),
                                         locs[:, 1].astype(np.float64),
                                         ep["t"][0]), 1e-300, 1.0)
    n = float(ep["n_meas"][0]) if "n_meas" in ep else 1.0
    k = float(outcome)
    return _DELTA * (k / p1 + (n - k) / np.maximum(1.0 - p1, 1e-300))


def _port_spec(model, outcome, locs, ep):
    return model.fused_spec(outcome, torch.from_numpy(locs),
                            {k: torch.from_numpy(v) for k, v in ep.items()})


@pytest.mark.parametrize("n", [257, N])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_user_tile_matches_pallas_interpret(case, n):
    name, model_t, model_j, outcome, ep = case
    locs, lw = _bank(n, n + len(name))
    tile_t, scal_t, cols_t = _port_spec(model_t, outcome, locs, ep)
    assert isinstance(tile_t.kernel_tile[1], str)  # the user library
    under = model_j.underlying_model or model_j
    pr1, _, cols_j = under._fused_pr1_parts(jnp.asarray(locs), ep)
    tile_j = (jfu.binomial_tile(pr1) if name == "binomial"
              else jfu.two_outcome_tile(pr1))
    j_lw, j_ln, j_ess = jfu.fused_bayes_update(
        tile_j, jnp.asarray(scal_t.numpy()), jnp.asarray(lw), cols_j,
        tile=1024, interpret=True)
    counts = (tfu.fused_bayes_update.launches,
              tfu.fused_bayes_update.user_launches)
    t_lw, t_ln, t_ess = tfu.fused_bayes_update(
        tile_t, scal_t, torch.from_numpy(lw), cols_t)
    assert (tfu.fused_bayes_update.launches,
            tfu.fused_bayes_update.user_launches) == counts  # CPU: plain
    assert_log_weights_close(t_lw.numpy(), j_lw,
                             _conditioning(outcome, ep, locs))
    np.testing.assert_allclose(float(t_ln), float(j_ln), atol=LN_ATOL)
    np.testing.assert_allclose(float(t_ess), float(j_ess), rtol=ESS_RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_fused_update_matches_jax(case):
    """Model.fused_update end to end on both sides, the binomial model's
    scalars (log C by lgamma) included."""
    name, model_t, model_j, outcome, ep = case
    locs, lw = _bank(1024, 5)
    j = model_j.fused_update(jnp.int32(outcome), jnp.asarray(lw),
                             jnp.asarray(locs),
                             {k: jnp.asarray(v) for k, v in ep.items()},
                             interpret=True)
    t = model_t.fused_update(outcome, torch.from_numpy(lw),
                             torch.from_numpy(locs),
                             {k: torch.from_numpy(v) for k, v in ep.items()})
    assert_log_weights_close(t[0].numpy(), j[0],
                             _conditioning(outcome, ep, locs))
    np.testing.assert_allclose(float(t[1]), float(j[1]), atol=LN_ATOL)
    np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=ESS_RTOL)


@pytest.mark.parametrize("path", [0, 1], ids=["single_shots", "binomial"])
def test_batch_update_matches_jax_by_moments(path):
    """A short ``batch_update`` of the first records' experiments in both
    packages, fused route forced, from the same initial cloud."""
    _, model_t, _, n_meas = chip_smoke.USER_PATHS[path]
    model_j = (JLostVisibilityModel() if n_meas is None
               else qi.BinomialModel(JLostVisibilityModel()))
    ts, outcomes = chip_smoke.user_records()[path]
    ts, outcomes = ts[:24], outcomes[:24]
    ep = {"t": ts} if n_meas is None else {
        "t": ts, "n_meas": np.full(len(ts), n_meas, np.int32)}
    ju = qi.SMCUpdater(model_j, N, qi.UniformDistribution(
        chip_smoke.USER_PRIOR), zero_weight_policy="reset", seed=0)
    ju.config = dataclasses.replace(ju.config, use_fused_update=True)
    state0 = jax.tree_util.tree_map(np.asarray, ju.state)
    ju.batch_update(outcomes, ep)
    tu = qt.SMCUpdater(model_t, N, qt.UniformDistribution(
        chip_smoke.USER_PRIOR), zero_weight_policy="reset", seed=0,
        device="cpu")
    tu.config = dataclasses.replace(tu.config, use_fused_update=True)
    tu.state = state_from_numpy(state0)
    tu.batch_update(outcomes, ep)
    assert tu.resample_count > 0
    mean_t, cov_t = tu.est_mean().numpy(), tu.est_covariance_mtx().numpy()
    mean_j = np.asarray(ju.est_mean())
    var_t = np.diag(cov_t)
    var_j = np.diag(np.asarray(ju.est_covariance_mtx()))
    assert np.all(np.abs(mean_t - mean_j)
                  < 5 * np.sqrt(var_t + var_j) + 1e-6), (mean_t, mean_j)
    assert np.all((0.2 < var_t / var_j) & (var_t / var_j < 5.0))
    np.testing.assert_allclose(tu.normalization_record[0],
                               ju.normalization_record[0], rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_column_route_plain_bit_equal_to_user_tile(case):
    """The column route on the torch-only twin: ``GivenPr1`` under the same
    composition, the pr1 evaluated into its one column. Its plain version
    gives the user tile's bits, single bank and batched."""
    name, model_t, _, outcome, ep = case
    locs, lw = _bank(N, 11)
    tile, scal, cols = _port_spec(model_t, outcome, locs, ep)
    twin = type(tile)(chip_smoke.LOST_VISIBILITY_TORCH)
    assert twin.kernel_tile is None
    lw = torch.from_numpy(lw)
    given, scal_g, cols_g, route = tfu._route(twin, scal, cols, lw.shape,
                                              batched=False)
    assert route == "column" and given.kernel_tile == (tile.outcome_id, 9, ())
    assert scal_g.shape == (tile.head,) and len(cols_g) == 1
    for a, b in zip(tfu.fused_update_plain(given, scal_g, lw, cols_g),
                    tfu.fused_update_plain(tile, scal, lw, cols)):
        assert torch.equal(a, b)
    # Batched: three trials of the same bank at three experiments.
    scal3 = scal.repeat(3, 1)
    scal3[:, -1] = torch.tensor([0.5, 3.0, 40.0])
    lw3, cols3 = lw.repeat(3, 1), tuple(c.repeat(3, 1) for c in cols)
    given, scal_g, cols_g, route = tfu._route(twin, scal3, cols3, lw3.shape,
                                              batched=True)
    assert route == "column" and cols_g[0].shape == (3, N)
    for a, b in zip(
            tfu.fused_update_plain_batched(given, scal_g, lw3, cols_g),
            tfu.fused_update_plain_batched(tile, scal3, lw3, cols3)):
        assert torch.equal(a, b)


def test_routes_of_the_tiles():
    """Built-in functors keep the built-in library, a user functor names
    its library by its source's hash, a pr1 with neither takes the column
    route, and any other tile is left for ``_fused_update_cuda`` to
    refuse."""
    x = torch.rand(16)
    scal = torch.tensor([1.0, 2.0])
    pre = tfu.two_outcome_tile(tfu.precession_pr1)
    assert tfu._route(pre, scal, (x,), x.shape, False)[3] == "builtin"
    user = tfu.two_outcome_tile(chip_smoke.LOST_VISIBILITY_CUDA)
    assert user.kernel_tile[1] == chip_smoke.LOST_VISIBILITY_CUDA.library_key
    assert tfu._route(user, scal, (x, x), x.shape, False)[3] == "user"
    bare = tfu.two_outcome_tile(lambda s, off, p: p)
    assert tfu._route(bare, scal, (x,), x.shape, False)[3] == "column"
    assert tfu._route(lambda s, p: p, scal, (x,), x.shape, False)[3] is None
    assert (tfu.cuda_pr1(len, "struct UserPr1 {};", (2,))
            == tfu.cuda_pr1(len, "struct UserPr1 {};", (2.0,)))
    with pytest.raises(ValueError, match="at most 4 constants"):
        tfu.cuda_pr1(len, "", consts=(1, 2, 3, 4, 5))


def test_user_translation_unit_and_cache_key(tmp_path, monkeypatch):
    src = chip_smoke.LOST_VISIBILITY_SOURCE
    unit = _build.user_translation_unit(src)
    assert unit.startswith('#include "fused_update.cuh"\n\nnamespace {\n')
    assert src.strip("\n") in unit
    assert unit.endswith("}  // namespace\n\n"
                         "QT_FUSED_UPDATE_FUNCTOR(UserPr1)\n")
    key = _build.user_digest(src)
    assert key == _build.user_digest(src) and len(key) == 16
    assert _build.user_digest(src + "\n// another source") != key
    header = tmp_path / "fused_update.cuh"
    header.write_bytes(_build.HEADER.read_bytes() + b"\n// another header")
    monkeypatch.setattr(_build, "HEADER", header)
    assert _build.user_digest(src) != key
    assert "#define QT_FUSED_UPDATE_FUNCTOR(Pr1)" in (
        Path(tfu.__file__).parent.parent / "csrc" / "fused_update.cuh"
    ).read_text()


def test_user_library_raises_without_nvcc(tmp_path, monkeypatch):
    """Without nvcc the user library's build raises, and so does a launch
    of the user tile: nothing takes the column route or the plain
    version."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    _build.user_library.cache_clear()
    tfu._capacity.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.user_library(chip_smoke.LOST_VISIBILITY_SOURCE)
        unit = (tmp_path / "user"
                / _build.user_digest(chip_smoke.LOST_VISIBILITY_SOURCE)
                / "user_pr1.cu")
        assert unit.read_text() == _build.user_translation_unit(
            chip_smoke.LOST_VISIBILITY_SOURCE)
        locs, lw = _bank(256, 1)
        tile, scal, cols = _port_spec(chip_smoke.LostVisibilityModel(), 1,
                                      locs, {"t": np.array([2.0],
                                                           np.float32)})
        counts = (tfu.fused_bayes_update.column_launches,
                  tfu.fused_bayes_update.launches)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfu._fused_update_cuda(tile, scal[None], torch.from_numpy(lw)[None],
                                   tuple(c[None] for c in cols))
        assert (tfu.fused_bayes_update.column_launches,
                tfu.fused_bayes_update.launches) == counts
    finally:
        _build.user_library.cache_clear()
        tfu._capacity.cache_clear()


def _census():
    """(model, expparams) of every fused model the port ships: the tiles
    of ``chip_smoke.ZOO`` and ``TOMO``, the flagship's and the accelerated
    precession model, and the binomial model over each two-outcome one."""
    out = [(case[1], case[4]) for case in chip_smoke.ZOO]
    out += [(case[1], case[4]) for case in chip_smoke.TOMO]
    out += [(qt.SimplePrecessionModel(), {"t": [2.0]}),
            (qt.AcceleratedPrecessionModel(), {"t": [2.0]})]
    out += [(qt.BinomialModel(m), {**ep, "n_meas": [10]}) for m, ep in out
            if not isinstance(m, qt.BinomialModel)]
    return out


def _shipped_fused_classes():
    found, todo = set(), [qt.FiniteOutcomeModel]
    while todo:
        cls = todo.pop()
        todo += cls.__subclasses__()
        if (cls.__module__.startswith("qinfer_tpu_torch.")
                and cls._fused_pr1_parts
                is not qt.FiniteOutcomeModel._fused_pr1_parts):
            found.add(cls)
    return found


def test_every_shipped_fused_model_has_a_builtin_functor():
    """No model the port ships takes the column route: each fused one has
    a built-in functor (an int id), and the census covers every class of
    the package that defines ``_fused_pr1_parts``."""
    covered = set()
    for model, ep in _census():
        assert model.fused_update_supported, model
        n = model.n_modelparams
        ep = {k: torch.as_tensor(v) for k, v in ep.items()}
        tile, _, _ = model.fused_spec(0, torch.rand(64, n), ep)
        assert isinstance(tile.kernel_tile[1], int), model
        covered.add(type(getattr(model, "underlying_model", None) or model))
    missing = _shipped_fused_classes() - covered
    assert not missing, missing
