"""Port parity for the model zoo of BASELINE configs 2–4 (CPU).

``pr0`` and ``log_likelihood`` of every newly ported model against the JAX
package on the same seeded locations and several experiments; the binomial
pmfs; the combinator surface; validity and ``canonicalize``; and the two
repairs of the SMC engine (time dependence through combinators, record-
array expparams).

Tolerances: probabilities atol 2e-6 — an ulp or two of f32 at 1 (1.2e-7),
amplified by RB's m·|log p| ≤ 8 for the lengths used; likelihoods from
``log_likelihood`` rtol 1e-3 plus atol 1e-6, since log L of a binomial
over up to 300 shots turns that error into k·δ/p1 + (n−k)·δ/(1−p1).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.utils import log_binomial_pdf as j_log_binomial_pdf
from qinfer_tpu_torch.interop import from_reference, state_from_numpy
from qinfer_tpu_torch.models.base import Simulatable
from qinfer_tpu_torch.smc import _is_time_dependent
from qinfer_tpu_torch.utils import (
    binomial_pdf,
    log_binomial_coefficient,
    log_binomial_pdf,
    pytree_to_expparams,
)

torch.set_num_threads(2)

P_ATOL = 2e-6

# name, JAX model, prior box, expparams of three experiments, outcomes.
MODELS = [
    ("inversion", qi.SimpleInversionModel(), [[0, 1]],
     {"w_": [0.3, 0.5, 0.0], "t": [4.0, 10.0, 40.0]}, [0, 1]),
    ("coin", qi.CoinModel(), [[0, 1]], {"dummy": [0.0, 0.0, 0.0]}, [0, 1]),
    ("noisy_coin", qi.NoisyCoinModel(), [[0, 1]],
     {"alpha": [0.9, 0.8, 1.0], "beta": [0.1, 0.3, 0.0]}, [0, 1]),
    ("multicos", qi.MultiCosModel(n_terms=2), [[0, 1], [0, 1]],
     {"ts": [[1.3, 0.4], [2.0, 5.0], [0.1, 9.0]]}, [0, 1]),
    ("multicos3", qi.MultiCosModel(n_terms=3), [[0, 1]] * 3,
     {"ts": [[1.3, 0.4, 2.0], [2.0, 5.0, 0.5], [0.1, 9.0, 3.0]]}, [0, 1]),
    ("known_t2", qi.KnownT2PrecessionModel(t2=100.0), [[0, 1]],
     {"t": [7.0, 50.0, 300.0]}, [0, 1]),
    ("rb", qi.rb.RandomizedBenchmarkingModel(),
     [[0.85, 1.0], [0.2, 0.6], [0.3, 0.55]], {"m": [1, 32, 256]}, [0, 1]),
    ("rb_interleaved", qi.rb.RandomizedBenchmarkingModel(interleaved=True),
     [[0.8, 1.0], [0.8, 1.0], [0.2, 0.5], [0.3, 0.5]],
     {"m": [1, 24, 100], "reference": [0, 1, 0]}, [0, 1]),
    ("binomial_precession", qi.BinomialModel(qi.SimplePrecessionModel()),
     [[0, 1]], {"t": [2.0, 20.0, 80.0], "n_meas": [40, 40, 10]},
     [0, 3, 10]),
    ("binomial_rb", qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel()),
     [[0.85, 1.0], [0.2, 0.6], [0.3, 0.55]],
     {"m": [1, 16, 256], "n_meas": [300, 300, 300]}, [0, 150, 210, 300]),
    ("binomial_known_t2",
     qi.DifferentiableBinomialModel(qi.KnownT2PrecessionModel(t2=30.0)),
     [[0, 1]], {"t": [1.0, 7.0, 60.0], "n_meas": [20, 20, 20]}, [0, 7, 20]),
]
IDS = [m[0] for m in MODELS]


def _locs(box, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    box = np.asarray(box, np.float64)
    # A margin around the box reaches the clip branches and invalid points.
    lo, hi = box[:, 0] - 0.05, box[:, 1] + 0.05
    return (lo + (hi - lo) * rng.random((n, len(box)))).astype(np.float32)


def _ep(ep, lib):
    out = {}
    for k, v in ep.items():
        a = np.asarray(v)
        a = a.astype(np.int32 if a.dtype.kind == "i" else np.float32)
        out[k] = jnp.asarray(a) if lib == "jax" else torch.from_numpy(a)
    return out


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_pr0_matches_jax(case):
    name, model_j, box, ep, _ = case
    if isinstance(model_j, qi.BinomialModel):
        model_j = model_j.underlying_model
    locs = _locs(box)
    j = np.asarray(model_j.pr0(jnp.asarray(locs), _ep(ep, "jax")))
    t = from_reference(model_j).pr0(torch.from_numpy(locs), _ep(ep, "torch"))
    assert t.shape == j.shape == (4096, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=P_ATOL, rtol=0)


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_log_likelihood_matches_jax(case):
    name, model_j, box, ep, outcomes = case
    locs = _locs(box, seed=1)
    j = np.asarray(model_j.log_likelihood(
        jnp.asarray(outcomes, jnp.int32), jnp.asarray(locs), _ep(ep, "jax")))
    t = from_reference(model_j).log_likelihood(
        torch.tensor(outcomes, dtype=torch.int32), torch.from_numpy(locs),
        _ep(ep, "torch")).numpy()
    assert t.shape == j.shape == (len(outcomes), 4096, 3)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(np.exp(t), np.exp(j), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_validity_and_canonicalize_match_jax(case):
    name, model_j, box, _, _ = case
    locs = _locs(box, seed=2)
    model_t = from_reference(model_j)
    valid_j = np.asarray(model_j.are_models_valid(jnp.asarray(locs)))
    valid_t = model_t.are_models_valid(torch.from_numpy(locs)).numpy()
    np.testing.assert_array_equal(valid_t, valid_j)
    assert 0 < valid_t.sum() < len(locs)  # both branches reached
    canon_j = np.asarray(model_j.canonicalize(jnp.asarray(locs)))
    canon_t = model_t.canonicalize(torch.from_numpy(locs))
    np.testing.assert_allclose(canon_t.numpy(), canon_j, rtol=1e-6,
                               atol=1e-7)
    # Valid up to one ulp: rescaling A and B by 1/(A + B) can leave
    # A + B = 1 + 2⁻²³, in the JAX package as here.
    nudged = canon_t - 2.0 ** -23 * (canon_t > 0.5)
    assert model_t.are_models_valid(torch.clamp(nudged, min=0.0)).all()


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_model_surface_matches_jax(case):
    name, model_j, _, ep, _ = case
    model_t = from_reference(model_j)
    assert type(model_t).__name__ == type(model_j).__name__
    assert model_t.n_modelparams == model_j.n_modelparams
    assert tuple(model_t.modelparam_names) == tuple(model_j.modelparam_names)
    assert model_t.expparams_dtype == model_j.expparams_dtype
    assert model_t.is_n_outcomes_constant == model_j.is_n_outcomes_constant
    assert model_t.n_outcomes(ep) == model_j.n_outcomes(ep)
    np.testing.assert_array_equal(model_t.all_outcomes(ep).numpy(),
                                  np.asarray(model_j.all_outcomes(ep)))
    np.testing.assert_array_equal(model_t.Q.numpy(), np.asarray(model_j.Q))
    assert model_t.fused_update_supported == model_j.fused_update_supported
    assert type(model_t.base_model).__name__ == \
        type(model_j.base_model).__name__
    assert [type(m).__name__ for m in model_t.model_chain] == \
        [type(m).__name__ for m in model_j.model_chain]
    assert (model_t.underlying_model is None) == \
        (model_j.underlying_model is None)


def test_binomial_pdfs_match_jax():
    n = np.array([40, 40, 40, 40, 300, 300, 1, 0], np.float32)
    k = np.array([0, 40, 3, 0, 210, 300, 1, 0], np.float32)
    p = np.array([0.0, 1.0, 0.5, 1.0, 0.7, 1e-30, 1.0, 0.3], np.float32)
    j = np.asarray(j_log_binomial_pdf(n, k, p))
    t = log_binomial_pdf(torch.from_numpy(n), torch.from_numpy(k),
                         torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(t[np.isfinite(j)], j[np.isfinite(j)],
                               rtol=1e-6, atol=1e-5)
    assert t[0] == 0.0 and t[1] == 0.0  # 0·log 0 = 0 at p ∈ {0, 1}
    assert np.isneginf(t[3])  # impossible outcome
    np.testing.assert_allclose(
        binomial_pdf(torch.tensor(40.0), torch.tensor(3.0),
                     torch.tensor(0.5)).item(),
        np.asarray(qi.utils.binomial_pdf(40.0, 3.0, 0.5)), rtol=1e-5)
    np.testing.assert_allclose(
        log_binomial_coefficient(torch.tensor(300.0),
                                 torch.tensor(210.0)).item(),
        float(qi.utils.log_binomial_coefficient(300.0, 210.0)), rtol=1e-6)


def test_rb_fidelity_conversions_match_jax():
    for F_ in (0.5, 0.9, 0.99):
        assert qt.rb.p(F_) == pytest.approx(qi.rb.p(F_))
        assert qt.rb.p(F_, d=4) == pytest.approx(qi.rb.p(F_, d=4))
    for p_ in (0.9, 0.97):
        assert qt.rb.F(p_) == pytest.approx(qi.rb.F(p_))
        assert qt.rb.F(qt.rb.p(p_)) == pytest.approx(p_)


def test_binomial_n_outcomes_needs_expparams():
    with pytest.raises(ValueError, match="requires expparams"):
        qt.BinomialModel(qt.SimplePrecessionModel()).n_outcomes()


# -- repairs of the SMC engine -------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class _Drifting(qt.SimplePrecessionModel):
    def update_timestep(self, modelparams, expparams, generator=None):
        return (modelparams + 0.25)[:, :, None]


def test_time_dependence_walks_the_combinator_chain():
    assert not _is_time_dependent(qt.SimplePrecessionModel())
    assert not _is_time_dependent(qt.BinomialModel(qt.SimplePrecessionModel()))
    assert not _is_time_dependent(
        qt.BinomialModel(qt.BinomialModel(qt.RandomizedBenchmarkingModel())))
    assert _is_time_dependent(_Drifting())
    assert _is_time_dependent(qt.DerivedModel(_Drifting()))
    assert _is_time_dependent(qt.BinomialModel(_Drifting()))


def _state(locs):
    n = locs.shape[0]
    return state_from_numpy({
        "particle_locations": locs,
        "particle_log_weights": np.full(n, -np.log(n), np.float32),
        "n_resamples": 0, "min_n_ess": float(n), "log_total_likelihood": 0.0,
        "just_resampled": False, "n_zero_weight_events": 0})


@pytest.mark.parametrize("underlying,moves", [(qt.SimplePrecessionModel(),
                                               False), (_Drifting(), True)])
def test_update_step_runs_timestep_only_for_drifting_models(
        underlying, moves, monkeypatch):
    """A BinomialModel over a static model runs no update_timestep over
    the bank (not even the identity); over a drifting one it runs the
    drift."""
    identity = Simulatable.update_timestep
    calls = []

    def spy(self, *args, **kwargs):
        calls.append(1)
        return identity(self, *args, **kwargs)

    monkeypatch.setattr(Simulatable, "update_timestep", spy)
    locs = _locs([[0, 1]], n=512)
    st, _ = qt.smc_update_step(
        qt.BinomialModel(underlying), qt.LiuWestResampler(),
        qt.SMCConfig(resample_thresh=-1.0), _state(locs), 3,
        {"t": torch.tensor([2.0]), "n_meas": torch.tensor([10])})
    np.testing.assert_allclose(st.particle_locations.numpy() - locs,
                               0.25 if moves else 0.0, atol=1e-6)
    assert not calls


def _record(n):
    rec = np.zeros(n, dtype=[("t", "f4"), ("n_meas", "u4")])
    rec["t"] = np.linspace(0.5, 9.0, n)
    rec["n_meas"] = 40
    return rec


def test_pytree_to_expparams():
    d = pytree_to_expparams(_record(3))
    assert set(d) == {"t", "n_meas"}
    np.testing.assert_array_equal(d["t"].numpy(), _record(3)["t"])
    np.testing.assert_array_equal(d["n_meas"].numpy(), 40)


def test_record_array_expparams_match_dict_form():
    """update and batch_update accept NumPy record arrays, the reference's
    native format, and give the same result as the dict form."""
    model = qt.BinomialModel(qt.SimplePrecessionModel())
    counts = np.array([3, 11, 25, 30], np.int32)
    rec = _record(4)

    def fresh():
        return qt.SMCUpdater(model, 2048, qt.UniformDistribution([0, 1]),
                             zero_weight_policy="reset", seed=4, device="cpu")

    by_rec, by_dict = fresh(), fresh()
    by_rec.update(int(counts[0]), rec[:1])
    by_dict.update(int(counts[0]), {"t": np.float32(rec["t"][0]),
                                    "n_meas": np.int32(40)})
    by_rec.batch_update(counts[1:], rec[1:])
    by_dict.batch_update(counts[1:], {"t": rec["t"][1:],
                                      "n_meas": np.full(3, 40, np.int32)})
    np.testing.assert_array_equal(by_rec.particle_log_weights.numpy(),
                                  by_dict.particle_log_weights.numpy())
    np.testing.assert_array_equal(by_rec.particle_locations.numpy(),
                                  by_dict.particle_locations.numpy())
    assert by_rec.normalization_record == by_dict.normalization_record
    assert len(by_rec.data_record) == 4
