"""Port parity for ``tomography/`` (CPU): bases, priors, models.

Inputs are made with numpy from a seed and go through the JAX function and
its port. Tolerances:

- deterministic parts (basis transforms, ``_gram``/``_cmm`` on injected
  normals, ``pr0``, both ``canonicalize`` paths): atol 1e-6, plus 2 ulps
  of the largest term where a contraction sums terms in another order
  (XLA's CPU dot and einsum contract into FMAs, torch's matmul does not);
- ``log_likelihood``: the same, divided by the likelihood (log turns an
  absolute error δ in pr into δ/pr);
- the PSD test (the port's LDLᴴ factorization): equal to the JAX
  package's characteristic-polynomial test and to eigvalsh on the
  decisive cases of ``tests/test_tomography.py``;
- stochastic parts (prior samples, the diffusive walk): first and second
  moments within five standard errors of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu.tomography as jt
import qinfer_tpu_torch as qt
import qinfer_tpu_torch.tomography as tt
from qinfer_tpu.tomography import distributions as jdist
from qinfer_tpu.tomography.models import _psd_via_charpoly as j_charpoly
from qinfer_tpu_torch.interop import from_reference
from qinfer_tpu_torch.tomography import distributions as tdist
from qinfer_tpu_torch.tomography.models import _psd_via_ldl as t_ldl

torch.set_num_threads(2)

ULP = 2.0 ** -23
BASES = {
    "pauli1": lambda m: m.pauli_basis(1),
    "gm2": lambda m: m.gell_mann_basis(2),
    "gm3": lambda m: m.gell_mann_basis(3),
    "pauli2": lambda m: m.pauli_basis(2),
    "pauli3": lambda m: m.pauli_basis(3),
    "pauli1x2": lambda m: m.tensor_product_basis(m.pauli_basis(1),
                                                 m.pauli_basis(1)),
}


def _pair(name):
    return BASES[name](jt), BASES[name](tt)


def _close(t, j, scale=1.0, atol=1e-6):
    """|t − j| ≤ atol + 2 ulps of ``scale`` (the largest summed term)."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=0, atol=atol + 2 * ULP * scale)


def _states(basis, n, seed, rank=None):
    """Ginibre density matrices drawn with numpy, as complex64 (n, d, d)."""
    d = basis.dim
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n, d, rank or d))
         + 1j * rng.standard_normal((n, d, rank or d)))
    rho = g @ g.conj().transpose(0, 2, 1)
    return (rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]).astype(
        np.complex64)


def _coords(basis_j, rho):
    return np.array(basis_j.state_to_modelparams(rho))


@pytest.mark.parametrize("name", list(BASES))
def test_basis_matches_jax(name):
    bj, bt = _pair(name)
    np.testing.assert_array_equal(bt.data, bj.data)
    assert bt.dims == tuple(bj.dims) and bt.labels == tuple(bj.labels)
    assert (bt.dim, bt.n_elements, len(bt)) == (bj.dim, bj.n_elements,
                                                len(bj))
    np.testing.assert_array_equal(bt.flat(), bj.flat())
    converted = from_reference(bj)
    np.testing.assert_array_equal(converted.data, bj.data)
    assert converted.labels == bt.labels


@pytest.mark.parametrize("name", list(BASES))
def test_real_pair_transforms_match_jax(name):
    bj, bt = _pair(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, bj.n_elements)).astype(np.float32)
    scale = float(np.abs(x).sum(1).max())
    re_j, im_j = bj.real_imag_from_coords(jnp.asarray(x))
    re_t, im_t = bt.real_imag_from_coords(torch.from_numpy(x))
    _close(re_t, re_j, scale)
    _close(im_t, im_j, scale)
    re, im = np.array(re_j), np.array(im_j)
    back_j = bj.coords_from_real_imag(jnp.asarray(re), jnp.asarray(im))
    back_t = bt.coords_from_real_imag(torch.from_numpy(re),
                                      torch.from_numpy(im))
    _close(back_t, back_j, scale)
    _close(back_t, x, scale, atol=1e-5)  # a round trip
    _close(bt.real_embedding(torch.from_numpy(x)),
           bj.real_embedding(jnp.asarray(x)), scale)
    M = np.array(bj.real_embedding(jnp.asarray(x)))
    _close(bt.coords_from_embedding(torch.from_numpy(M)),
           bj.coords_from_embedding(jnp.asarray(M)), scale)


@pytest.mark.parametrize("name", ["pauli1", "gm3", "pauli2"])
def test_host_transforms_match_jax(name):
    bj, bt = _pair(name)
    rho = _states(bj, 16, 2)
    x_t = bt.state_to_modelparams(rho)
    assert x_t.dtype == torch.float32
    np.testing.assert_array_equal(x_t.numpy(), _coords(bj, rho))
    x = x_t.numpy()
    np.testing.assert_array_equal(bt.modelparams_to_state(x),
                                  bj.modelparams_to_state(x))
    np.testing.assert_array_equal(bt.modelparams_to_state(x_t),
                                  bj.modelparams_to_state(x))
    cov = np.cov(x.T).astype(np.float32)
    np.testing.assert_array_equal(bt.covariance_mtx_to_superop(cov),
                                  bj.covariance_mtx_to_superop(cov))


@pytest.mark.parametrize("shape", [(32, 2, 2), (32, 3, 1), (16, 4, 4)])
def test_gram_and_cmm_on_injected_normals(shape):
    rng = np.random.default_rng(shape[1])
    gr, gi = (rng.standard_normal(shape).astype(np.float32) for _ in "ri")
    scale = float(2 * np.max(np.abs(gr)) ** 2 * shape[2])
    for t, j in zip(tdist._gram(torch.from_numpy(gr), torch.from_numpy(gi)),
                    jdist._gram(jnp.asarray(gr), jnp.asarray(gi))):
        _close(t, j, scale)
    sq = shape[:2] + (shape[1],)
    a, b, c, d = (rng.standard_normal(sq).astype(np.float32) for _ in "abcd")
    scale = float(2 * np.max(np.abs([a, b, c, d])) ** 2 * shape[1])
    for t, j in zip(tdist._cmm(*map(torch.from_numpy, (a, b, c, d))),
                    jdist._cmm(*map(jnp.asarray, (a, b, c, d)))):
        _close(t, j, scale)


def _prior_pairs():
    pj, pt = jt.pauli_basis(1), tt.pauli_basis(1)
    fid = np.array([[1.0, 0.0], [0.0, 0.0]], np.complex64)
    return [
        ("ginibre", jt.GinibreDistribution(pj), tt.GinibreDistribution(pt)),
        ("ginibre_rank1", jt.GinibreDistribution(pj, rank=1),
         tt.GinibreDistribution(pt, rank=1)),
        ("ginibre_2q", jt.GinibreDistribution(jt.pauli_basis(2)),
         tt.GinibreDistribution(tt.pauli_basis(2))),
        ("ginibre_3q", jt.GinibreDistribution(jt.pauli_basis(3)),
         tt.GinibreDistribution(tt.pauli_basis(3))),
        ("redit", jt.GinibreReditDistribution(jt.gell_mann_basis(2)),
         tt.GinibreReditDistribution(tt.gell_mann_basis(2))),
        ("bcsz", jt.BCSZChoiDistribution(2), tt.BCSZChoiDistribution(2)),
        ("gadfli", jt.GADFLIDistribution(jt.GinibreDistribution(pj), fid,
                                         max_alpha=0.5),
         tt.GADFLIDistribution(tt.GinibreDistribution(pt), fid,
                               max_alpha=0.5)),
        ("hs_uniform", jt.HilbertSchmidtUniform(3),
         tt.HilbertSchmidtUniform(3)),
        ("haar", jt.HaarUniform(2), tt.HaarUniform(2)),
        ("ginibre_uniform", jt.GinibreUniform(rank=1, dim=3),
         tt.GinibreUniform(rank=1, dim=3)),
    ]


@pytest.mark.parametrize("case", _prior_pairs(), ids=lambda c: c[0])
def test_prior_moments_match_jax(case):
    """First and second moments of the coordinates within 5 standard
    errors of the JAX prior's; every sample is a physical state."""
    _, pj, pt = case
    n = 4000
    xj = np.asarray(pj.sample(jax.random.PRNGKey(3), n), np.float64)
    xt_t = pt.sample(torch.Generator().manual_seed(3), n)
    assert xt_t.shape == (n, pj.n_rvs) and xt_t.dtype == torch.float32
    xt = xt_t.numpy().astype(np.float64)
    for fj, ft in ((xj, xt), (xj ** 2, xt ** 2)):
        se = np.sqrt((fj.var(0) + ft.var(0)) / n)
        assert np.all(np.abs(fj.mean(0) - ft.mean(0)) <= 5 * se + 1e-6)
    model = tt.TomographyModel(pt.basis)
    assert bool(model.are_models_valid(xt_t).all())
    assert type(from_reference(pj)) is type(pt)


def test_bcsz_choi_states_are_trace_preserving():
    dist = tt.BCSZChoiDistribution(2)
    choi = dist.basis.modelparams_to_state(
        dist.sample(torch.Generator().manual_seed(0), 64))
    np.testing.assert_allclose(np.trace(choi, axis1=1, axis2=2).real, 1.0,
                               atol=1e-4)
    ptr = np.einsum("niaja->nij", choi.reshape(-1, 2, 2, 2, 2))
    np.testing.assert_allclose(ptr, np.tile(np.eye(2) / 2, (64, 1, 1)),
                               atol=1e-4)
    states = dist._sample_states(torch.Generator().manual_seed(1), 8)
    assert states.shape == (8, 4, 4) and np.iscomplexobj(states)


def _model_pairs():
    return [
        ("pauli1", jt.TomographyModel(jt.pauli_basis(1)),
         tt.TomographyModel(tt.pauli_basis(1))),
        ("pauli2", jt.TomographyModel(jt.pauli_basis(2)),
         tt.TomographyModel(tt.pauli_basis(2))),
        ("pauli3", jt.TomographyModel(jt.pauli_basis(3)),
         tt.TomographyModel(tt.pauli_basis(3))),
        ("gm3_subnormalized",
         jt.TomographyModel(jt.gell_mann_basis(3), allow_subnormalized=True),
         tt.TomographyModel(tt.gell_mann_basis(3),
                            allow_subnormalized=True)),
        ("diffusive", jt.DiffusiveTomographyModel(jt.pauli_basis(1)),
         tt.DiffusiveTomographyModel(tt.pauli_basis(1))),
    ]


def _model_inputs(model_j, n, seed):
    """(params, expparams) as numpy: Ginibre coordinates (plus ε for the
    diffusive model) and three projector effects."""
    basis = model_j.basis
    x = _coords(basis, _states(basis, n, seed))
    eff = _coords(basis, _states(basis, 3, seed + 1, rank=1))
    ep = {"meas": eff}
    if isinstance(model_j, jt.DiffusiveTomographyModel):
        rng = np.random.default_rng(seed)
        x = np.concatenate([x, 0.05 * rng.random((n, 1), np.float32)], 1)
        ep["t"] = np.ones(3, np.float32)
    return x.astype(np.float32), ep


@pytest.mark.parametrize("case", _model_pairs(), ids=lambda c: c[0])
def test_likelihood_matches_jax(case):
    _, mj, mt = case
    x, ep = _model_inputs(mj, 256, 4)
    ep_t = {k: torch.from_numpy(v) for k, v in ep.items()}
    ep_j = {k: jnp.asarray(v) for k, v in ep.items()}
    pr0_t = mt.pr0(torch.from_numpy(x), ep_t).numpy()
    pr0_j = np.asarray(mj.pr0(jnp.asarray(x), ep_j))
    scale = float(np.abs(x).max() * np.abs(ep["meas"]).max()) * x.shape[1]
    _close(pr0_t, pr0_j, scale)
    outcomes = np.array([0, 1])
    ll_t = mt.log_likelihood(outcomes, torch.from_numpy(x), ep_t).numpy()
    ll_j = np.asarray(mj.log_likelihood(jnp.asarray(outcomes),
                                        jnp.asarray(x), ep_j))
    assert ll_t.shape == (2, 256, 3)
    pr = np.clip(np.stack([pr0_j, 1 - pr0_j]), 1e-35, 1)
    assert np.all(np.abs(ll_t - ll_j) <= 1e-6 + (2 * ULP * scale + 1e-7) / pr)
    L = np.exp(ll_t)
    np.testing.assert_allclose(L.sum(0), 1.0, atol=1e-5)
    # The Born rule against ρ directly.
    rho = mt.basis.modelparams_to_state(x[:, :mt.basis.n_elements])
    eff = mt.basis.modelparams_to_state(ep["meas"])
    direct = np.einsum("nab,eba->ne", rho, eff).real
    np.testing.assert_allclose(L[1], np.clip(direct, 0, 1), atol=1e-5)
    assert type(from_reference(mj)) is type(mt)
    assert from_reference(mj).allow_subnormalized == mt.allow_subnormalized


@pytest.mark.parametrize("case", _model_pairs(), ids=lambda c: c[0])
def test_fused_spec_matches_jax(case):
    """Same pr1 tail and columns as the JAX model's _fused_pr1_parts; the
    diffusive model's ε column is left out; the tile has a CUDA functor."""
    _, mj, mt = case
    x, ep = _model_inputs(mj, 64, 5)
    ep1 = {k: v[:1] for k, v in ep.items()}
    _, tail_j, cols_j = mj._fused_pr1_parts(jnp.asarray(x),
                                            {k: jnp.asarray(v)
                                             for k, v in ep1.items()})
    pr1, tail_t, cols_t = mt._fused_pr1_parts(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in ep1.items()})
    n_el = mt.basis.n_elements
    assert len(cols_t) == len(cols_j) == n_el and pr1.n_cols == n_el
    np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
    for a, b in zip(cols_t, cols_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mt.fused_update_supported
    tile, scal, _ = mt.fused_spec(1, torch.from_numpy(x),
                                  {k: torch.from_numpy(v)
                                   for k, v in ep1.items()})
    assert tile.kernel_tile == (0, 8, ())
    np.testing.assert_array_equal(scal.numpy()[1:], np.asarray(tail_j))


def _validity_cases(basis_j, seed):
    """Valid, boundary (scaled to the Bloch-ball surface) and far-outside
    coordinates, as tests/test_tomography.py builds them."""
    valid = _coords(basis_j, _states(basis_j, 64, seed))
    boundary = valid[:16].copy()
    boundary[:, 1:] *= (1.0 / np.maximum(
        np.linalg.norm(boundary[:, 1:], axis=1, keepdims=True), 1e-9)
    ) * boundary[:, :1]
    junk = valid[:16].copy()
    junk[:, 1:] *= 3.0
    return np.concatenate([valid, boundary, junk]).astype(np.float32)


@pytest.mark.parametrize("name", ["pauli1", "pauli2", "gm3"])
def test_charpoly_psd_test_matches_jax_and_eigvalsh(name):
    bj, bt = _pair(name)
    cases = _validity_cases(bj, 7)
    M = np.array(bj.real_embedding(jnp.asarray(cases)))
    evals = np.linalg.eigvalsh(M)
    tol = 1e-5
    ref = (evals >= -tol).all(axis=-1)
    got = t_ldl(*bt.real_imag_from_coords(torch.from_numpy(cases)),
                tol).numpy()
    decisive = np.abs(evals.min(axis=-1) + tol) > 1e-4
    assert decisive.sum() > len(cases) * 0.7
    np.testing.assert_array_equal(got[decisive], ref[decisive])
    np.testing.assert_array_equal(
        got[decisive], np.asarray(j_charpoly(jnp.asarray(M), tol))[decisive])
    mj, mt = jt.TomographyModel(bj), tt.TomographyModel(bt)
    np.testing.assert_array_equal(
        mt.are_models_valid(torch.from_numpy(cases)).numpy()[decisive],
        np.asarray(mj.are_models_valid(jnp.asarray(cases)))[decisive])


def test_three_qubit_psd_test_matches_eigvalsh_and_jax_where_it_is_right():
    """At d = 8 the port's LDLᴴ test decides every decisive row as
    eigvalsh does. The JAX package's characteristic-polynomial test of the
    16 × 16 embedding in f32 accepts some rows whose lowest eigenvalue
    lies 1e-3 to 3e-2 below −psd_tol (8 of the 93 decisive rows here, all
    of them scaled far outside); wherever it agrees with eigvalsh the port
    agrees with it, and where it does not, the port rejects a row that the
    JAX package accepts, never the other way round."""
    bj, bt = _pair("pauli3")
    cases = _validity_cases(bj, 7)
    M = np.array(bj.real_embedding(jnp.asarray(cases)))
    evals = np.linalg.eigvalsh(M)
    tol = 1e-5
    ref = (evals >= -tol).all(axis=-1)
    decisive = np.abs(evals.min(axis=-1) + tol) > 1e-4
    assert decisive.sum() > len(cases) * 0.7
    got = t_ldl(*bt.real_imag_from_coords(torch.from_numpy(cases)),
                tol).numpy()
    np.testing.assert_array_equal(got[decisive], ref[decisive])
    mj, mt = jt.TomographyModel(bj), tt.TomographyModel(bt)
    port = mt.are_models_valid(torch.from_numpy(cases)).numpy()
    jax_ = np.asarray(mj.are_models_valid(jnp.asarray(cases)))
    charpoly = np.asarray(j_charpoly(jnp.asarray(M), tol))
    right = decisive & (charpoly == ref)
    np.testing.assert_array_equal(port[right], jax_[right])
    wrong = decisive & (charpoly != ref)
    assert wrong.sum() < 0.1 * decisive.sum()
    assert not port[wrong].any() and charpoly[wrong].all()
    assert np.all(evals.min(axis=-1)[wrong] < -1e-3)


@pytest.mark.parametrize("subnormalized", [False, True])
@pytest.mark.parametrize("name", ["pauli1", "pauli2", "gm3", "pauli3"])
def test_psd_valid_on_the_host_is_are_models_valid(name, subnormalized):
    """``ops.psd_valid`` on a CPU bank is the model's own test, bit for bit
    (for qubits the LDLᴴ test against the closed form), and so is the
    diffusive model's on its coordinate view."""
    from qinfer_tpu_torch.ops.psd_valid import psd_valid

    bj, bt = _pair(name)
    cases = torch.from_numpy(_validity_cases(bj, 7))
    cases[-24:, 0] *= torch.linspace(0.7, 1.3, 24)
    model = tt.TomographyModel(bt, allow_subnormalized=subnormalized)
    want = model.are_models_valid(cases)
    assert 0 < int(want.sum()) < len(cases)
    assert torch.equal(psd_valid(cases, bt, model.psd_tol, subnormalized),
                       want)
    bank = torch.cat([cases, torch.ones((len(cases), 1))], dim=1)
    diffusive = tt.DiffusiveTomographyModel(
        bt, allow_subnormalized=subnormalized)
    assert torch.equal(diffusive.are_models_valid(bank), want)


@pytest.mark.parametrize("name", ["pauli1", "pauli2", "gm3", "pauli3"])
def test_canonicalize_matches_jax(name):
    """The closed-form qubit path and the eigh path for d > 2 (an
    eigendecomposition of the embedding, whose doubled eigenvalues make the
    eigenvectors ambiguous: the projection is compared, not them)."""
    bj, bt = _pair(name)
    rng = np.random.default_rng(11)
    x = _validity_cases(bj, 8)
    x[:, 1:] += 0.2 * rng.standard_normal(x[:, 1:].shape).astype(np.float32)
    x[-24:, 0] *= 1.0 + rng.uniform(-0.3, 0.3, 24).astype(np.float32)
    mj, mt = jt.TomographyModel(bj), tt.TomographyModel(bt)
    got = mt.canonicalize(torch.from_numpy(x))
    ref = np.asarray(mj.canonicalize(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert bool(mt.are_models_valid(got).all())
    if bt.dim == 2:  # the closed form equals the generic eigh path
        M = bt.real_embedding(torch.from_numpy(x)).double()
        evals, evecs = torch.linalg.eigh(M)
        evals = torch.clamp(evals, min=mt.psd_tol)
        evals = 2.0 * evals / evals.sum(-1, keepdim=True)
        slow = bt.coords_from_embedding(
            ((evecs * evals[..., None, :]) @ evecs.transpose(-1, -2)).float())
        np.testing.assert_allclose(got.numpy(), slow.numpy(), atol=2e-5)


def test_diffusive_walk_matches_jax_by_moments():
    """update_timestep: the walk's first and second moments within 5
    standard errors of the JAX package's on the same bank; ε is kept, the
    evolved states are physical, the shape is (N, d²+1, E)."""
    mj = jt.DiffusiveTomographyModel(jt.pauli_basis(1))
    mt = tt.DiffusiveTomographyModel(tt.pauli_basis(1))
    n = 4000
    state = _coords(mj.basis, _states(mj.basis, 1, 9))[0]
    x = np.tile(np.concatenate([state, [0.08]]), (n, 1)).astype(np.float32)
    ep = {"meas": np.zeros((2, 4), np.float32),
          "t": np.array([0.5, 2.0], np.float32)}
    sj = np.asarray(mj.update_timestep(jnp.asarray(x),
                                       {k: jnp.asarray(v)
                                        for k, v in ep.items()},
                                       key=jax.random.PRNGKey(1)))
    st = mt.update_timestep(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in ep.items()},
                            generator=torch.Generator().manual_seed(1))
    assert st.shape == sj.shape == (n, 5, 2)
    st = st.numpy().astype(np.float64)
    for e in range(2):
        a, b = sj[:, :, e].astype(np.float64), st[:, :, e]
        for fa, fb in ((a, b), (a ** 2, b ** 2)):
            se = np.sqrt((fa.var(0) + fb.var(0)) / n)
            assert np.all(np.abs(fa.mean(0) - fb.mean(0)) <= 5 * se + 1e-6)
        assert bool(mt.are_models_valid(torch.from_numpy(
            b.astype(np.float32))).all())
    np.testing.assert_array_equal(st[:, 4, :], 0.08 * np.ones((n, 2),
                                                               np.float32))


def test_diffusive_likelihood_ignores_eps():
    mt = tt.DiffusiveTomographyModel(tt.pauli_basis(1))
    x = torch.from_numpy(_model_inputs(jt.DiffusiveTomographyModel(
        jt.pauli_basis(1)), 32, 6)[0])
    bumped = x.clone()
    bumped[:, -1] = 0.5
    ep = {"meas": torch.rand(2, 4), "t": torch.ones(2)}
    assert torch.equal(mt.pr0(x, ep), mt.pr0(bumped, ep))
    assert bool((mt.are_models_valid(bumped) == mt.are_models_valid(x)).all())
    negative = x.clone()
    negative[:, -1] = -0.1
    assert not bool(mt.are_models_valid(negative).any())
    fixed = mt.canonicalize(negative)
    assert bool((fixed[:, -1] == 0).all())


def test_tomography_exports_match_jax():
    """The port's tomography package exports what the JAX one does, the
    plotting helpers included."""
    import qinfer_tpu.tomography as j_pkg

    assert set(tt.__all__) == set(j_pkg.__all__)
    assert qt.tomography is tt
