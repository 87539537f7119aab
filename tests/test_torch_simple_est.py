"""Port parity for ``simple_est_prec`` and ``simple_est_rb`` (CPU).

The same numpy data (seeded) go through the JAX package's and the port's
one-call estimators; the two posterior means agree within Monte-Carlo
error: five joint posterior standard deviations, as in
``test_torch_smc.py`` (the two runs share no random stream). Also the
loaders, ``PostselectedDistribution`` and ``ConstantDistribution``.
"""

import io

import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt

torch.set_num_threads(2)


def _prec_data(true_omega=0.5, n_shots=40, n_exp=25, seed=0):
    rng = np.random.default_rng(seed)
    ts = (9 / 8) ** np.arange(n_exp)
    p1 = 1 - np.cos(0.5 * true_omega * ts) ** 2
    counts = rng.binomial(n_shots, p1)
    return np.stack([counts, ts, np.full(n_exp, n_shots)], axis=1)


def _rb_data(interleaved=False, seed=5):
    rng = np.random.default_rng(seed)
    true_p, A, B = 0.96, 0.45, 0.5
    ms = np.array([1, 2, 4, 8, 16, 32, 64, 128, 192, 256])
    n_shots = 400
    if not interleaved:
        counts = rng.binomial(n_shots, A * true_p ** ms + B)
        return np.stack([counts, ms, np.full(len(ms), n_shots)], axis=1)
    rows = []
    for ref, decay in ((1, true_p), (0, 0.98 * true_p)):
        counts = rng.binomial(n_shots, A * decay ** ms + B)
        rows.append(np.stack([counts, ms, np.full(len(ms), n_shots),
                              np.full(len(ms), ref)], axis=1))
    return np.concatenate(rows)


def _assert_means_agree(port, ref, coords):
    (m_t, c_t), (m_j, c_j) = port, ref
    assert m_t.shape == np.asarray(m_j).shape
    assert c_t.shape == np.asarray(c_j).shape
    for i in coords:
        sd = np.sqrt(c_t[i, i] + float(c_j[i, i]))
        assert abs(m_t[i] - float(m_j[i])) < 5 * sd + 1e-6, (i, m_t, m_j)


@pytest.mark.parametrize("omega,seed", [(0.5, 0), (0.73, 3)])
def test_simple_est_prec_matches_jax(omega, seed):
    data = _prec_data(omega, seed=seed)
    port = qt.simple_est_prec(data, device="cpu")
    ref = qi.simple_est_prec(data)
    _assert_means_agree(port, ref, (0,))
    assert abs(port[0][0] - omega) < 6 * np.sqrt(port[1][0, 0]) + 1e-3


@pytest.mark.parametrize("interleaved", [False, True])
def test_simple_est_rb_matches_jax(interleaved):
    data = _rb_data(interleaved)
    port = qt.simple_est_rb(data, interleaved=interleaved, p_min=0.8,
                            device="cpu")
    ref = qi.simple_est_rb(data, interleaved=interleaved, p_min=0.8)
    _assert_means_agree(port, ref, range(port[0].shape[0]))
    assert port[0].shape == (4 if interleaved else 3,)


def test_csv_text_file_and_extra():
    data = _prec_data(true_omega=0.73, seed=3)
    csv = "\n".join(",".join(f"{v:.6f}" for v in row) for row in data)
    mean, cov, extra = qt.simple_est_prec(csv, return_all=True,
                                          device="cpu")
    assert set(extra) == {"updater"}  # the reference's extra, kept
    assert isinstance(extra["updater"], qt.SMCUpdater)
    assert len(extra["updater"].normalization_record) == data.shape[0]
    from_file = qt.load_data_or_txt(io.StringIO(csv), 3)
    np.testing.assert_allclose(from_file, data, atol=1e-6)
    np.testing.assert_allclose(qt.load_data_or_txt(csv, 3),
                               qi.load_data_or_txt(csv, 3))


def test_load_data_or_txt_validates(tmp_path):
    with pytest.raises(ValueError, match="columns"):
        qt.load_data_or_txt(np.zeros((3, 2)), 3)
    with pytest.raises(TypeError):
        qt.load_data_or_txt(42, 3)
    path = tmp_path / "rows.csv"
    path.write_text("1,2,3\n4,5,6\n")
    np.testing.assert_array_equal(qt.load_data_or_txt(str(path), 3),
                                  [[1, 2, 3], [4, 5, 6]])


def test_simple_est_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.simple_est_prec(_prec_data())


def test_postselected_prior_is_valid():
    """The RB prior: after the redraw rounds and the clamp every sample is
    physical, on the uniform box's support, but for RB's clamp, which
    rescales A and B by 1/(A + B) and can leave A + B one ulp above 1
    (ROADMAP Queue C, as in the JAX package)."""
    model = qt.RandomizedBenchmarkingModel()
    prior = qt.PostselectedDistribution(
        qt.UniformDistribution([[0.8, 1.0], [0.0, 1.0], [0.0, 1.0]]), model,
        maxiters=5)
    x = prior.sample(torch.Generator().manual_seed(0), 5000)
    assert x.shape == (5000, 3) and prior.n_rvs == 3
    valid = model.are_models_valid(x)
    assert float(valid.float().mean()) > 0.97
    assert float((x[:, 1] + x[:, 2]).max()) <= 1.0 + 2.0 ** -22
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert float(x[:, 0].min()) >= 0.8


def test_constant_distribution():
    d = qt.ConstantDistribution([0.25, 0.5])
    x = d.sample(torch.Generator().manual_seed(0), 4)
    assert d.n_rvs == 2 and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), [[0.25, 0.5]] * 4)
    np.testing.assert_array_equal(
        np.asarray(qi.ConstantDistribution([0.25, 0.5]).sample(None, 4)),
        x.numpy())
