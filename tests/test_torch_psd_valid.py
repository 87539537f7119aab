"""The validity kernel of d = 3, 4, 8 tomography on the host (CPU).

- the route: the kernel only for CUDA banks at d = 3, 4 and 8;
- the module imports, and a CPU bank is tested, on a host without nvcc;
- the kernel's source, built by the host's g++ (``-ffp-contract=off``, a
  stub header for the CUDA names, each block's threads run twice so that
  the second pass finds the staged tile whole) and called through the
  wrapper with host pointers: equal to the plain version on every row
  whose smallest eigenvalue (f64) is more than 1e-6 from −psd_tol, at
  unit row stride and at the diffusive model's stride d² + 1, with and
  without subnormalised states; on degenerate rows and on the decisive
  rows nearest the threshold;
- the wrapper's checks, its launch count and its rows counter;
- the redraw round's kernel (``psd_redraw``), built the same way: a round
  over the mask, then one over the list it wrote, against the resampler's
  masked chain on one bank and on T banks of their own roots, the rows
  valid before untouched, every decisive row decided as the chain decides
  it, the rows both wrote within ``REDRAW_MAX_ULPS``, the count and list
  left the mask's; a round with no invalid row;
  its checks; and the Liu–West loop through the kernel's round against
  the loop through the masked chain, with the same draws.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qinfer_tpu_torch.tomography as tt
from qinfer_tpu_torch import profiling
from qinfer_tpu_torch.ops import psd_valid as pv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import _psd_host_kernel  # noqa: E402
from chip_smoke import (  # noqa: E402
    PSD_MARGIN as MARGIN,
    PSD_TOL as TOL,
    REDRAW_MAX_ULPS,
    min_eigenvalues,
    psd_valid_cases,
    redraw_round_agreement,
    redraw_round_case,
)

# d = 4 and 3, and d = 8 in the product-Pauli basis (monomial: one nonzero
# a row of each element) and in a dense one.
BASES = {"pauli2": lambda: tt.pauli_basis(2),
         "gm3": lambda: tt.gell_mann_basis(3),
         "pauli3": lambda: tt.pauli_basis(3),
         "gm8": lambda: tt.gell_mann_basis(8)}


@pytest.mark.parametrize("device_type,dim,kernel", [
    ("cuda", 3, True), ("cuda", 4, True), ("cuda", 2, False),
    ("cuda", 5, False), ("cuda", 8, True), ("cuda", 6, False),
    ("cpu", 3, False), ("cpu", 4, False), ("cpu", 2, False)])
def test_psd_valid_route(device_type, dim, kernel):
    assert pv.psd_valid_route(device_type, dim) is kernel


def test_imports_and_tests_a_cpu_bank_without_nvcc(tmp_path):
    code = (
        "import shutil, torch\n"
        "from qinfer_tpu_torch import _build\n"
        "import qinfer_tpu_torch.tomography as tt\n"
        "from qinfer_tpu_torch.ops import psd_valid as pv\n"
        "b = tt.pauli_basis(2)\n"
        "x = torch.zeros((3, 16)); x[:, 0] = 0.5\n"
        "ok = tt.TomographyModel(b).are_models_valid(x)\n"
        "print(shutil.which('nvcc'), bool(ok.all()), pv.psd_valid.launches,"
        " _build.library.cache_info().currsize)\n")
    env = dict(os.environ, PATH=str(Path(sys.executable).parent),
               CUDA_HOME=str(tmp_path / "no_cuda"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT,
                         env=env).stdout
    assert out.split() == ["None", "True", "0", "0"]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/psd_valid.cu built by g++ (``_psd_host_kernel.build``)."""
    lib = _psd_host_kernel.build(tmp_path_factory.mktemp("psd_valid"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


@pytest.fixture
def on_host(monkeypatch, host_kernel):
    """The wrapper's CUDA path on host tensors, launching ``host_kernel``."""
    for obj, name, value in _psd_host_kernel.patches(host_kernel):
        monkeypatch.setattr(obj, name, value)
    return host_kernel


@pytest.mark.parametrize("subnormalized", [False, True],
                         ids=["unit_trace", "subnormalized"])
@pytest.mark.parametrize("strided", [False, True], ids=["rows", "view"])
@pytest.mark.parametrize("name", list(BASES))
def test_kernel_source_matches_plain(on_host, name, strided, subnormalized):
    basis = BASES[name]()
    cases = torch.from_numpy(psd_valid_cases(basis, 4096 + 77, 5))
    if strided:  # the diffusive model's coordinate view: stride d² + 1
        bank = torch.cat([cases, torch.ones((len(cases), 1))], dim=1)
        cases = bank[:, :-1]
        assert cases.stride(0) == basis.n_elements + 1
    launches = pv.psd_valid.launches
    got = pv._psd_valid_cuda(cases, basis, TOL, subnormalized)
    assert pv.psd_valid.launches == launches + 1
    want = pv.psd_valid_plain(cases, basis, TOL, subnormalized)
    lam = min_eigenvalues(basis, cases.numpy())
    decisive = np.abs(lam + TOL) > MARGIN
    assert decisive.mean() > 0.95
    np.testing.assert_array_equal(got.numpy()[decisive],
                                  want.numpy()[decisive])
    assert 0.1 < want.float().mean() < 0.9  # both sides of the threshold


@pytest.mark.parametrize("name", ["pauli2", "pauli3", "gm8"])
def test_kernel_source_on_degenerate_rows(on_host, name):
    """Zeros, NaN, a pure state, the maximally mixed state, a trace just
    out of range and a row far outside, over two blocks, the second
    ragged; then the 32 decisive rows of ``psd_valid_cases`` nearest the
    threshold on each side (smallest eigenvalue more than PSD_MARGIN from
    −psd_tol), decided as the plain version and eigvalsh decide them."""
    basis = BASES[name]()
    d = basis.dim
    x = np.zeros((300, d * d), np.float32)
    x[:, 0] = 1 / np.sqrt(d)
    x[1] = 0.0
    x[2, 3] = np.nan
    x[3] = basis.state_to_modelparams(
        np.diag(np.eye(d)[0])[None])[0].numpy()
    x[4, 0] = 1 / np.sqrt(d) + 2e-4
    x[299, 5] = 0.6
    cases = psd_valid_cases(basis, 1 << 14, 11)
    lam = min_eigenvalues(basis, cases)
    gap = lam + TOL
    below = np.flatnonzero(gap < -MARGIN)
    above = np.flatnonzero(gap > MARGIN)
    near = np.concatenate([below[np.argsort(-gap[below])[:32]],
                           above[np.argsort(gap[above])[:32]]])
    x = np.concatenate([x, cases[near]])
    got = pv._psd_valid_cuda(torch.from_numpy(x), basis, TOL, False)
    want = pv.psd_valid_plain(torch.from_numpy(x), basis, TOL, False)
    assert torch.equal(got, want)
    assert got[[0, 3, 5]].all() and not got[[1, 2, 4, 299]].any()
    exact = (lam[near] >= -TOL) & pv.trace_ok(
        torch.from_numpy(cases[near, 0]), d, False).numpy()
    np.testing.assert_array_equal(got[300:].numpy(), exact)


def test_wrapper_counts_its_rows_while_a_profiler_records(on_host):
    basis = tt.gell_mann_basis(3)
    x = torch.from_numpy(psd_valid_cases(basis, 1000, 3))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("qinfer.resamplers.valid"):
            pv.psd_valid(x, basis, TOL)  # CPU: the plain version
            pv._psd_valid_cuda(x, basis, TOL, False)
            pv._psd_valid_cuda(x[:10], basis, TOL, False)
    assert profiling.recorded()["counters"]["ops.psd_valid.rows"] == 1010


@pytest.mark.parametrize("case", ["qubit", "d5", "f64", "columns",
                                  "column_stride", "one_dim"])
def test_wrapper_refuses_what_the_kernel_cannot_take(on_host, case):
    basis = tt.pauli_basis(1) if case == "qubit" else (
        tt.gell_mann_basis(5) if case == "d5" else tt.pauli_basis(2))
    x = torch.zeros((8, basis.n_elements))
    if case == "f64":
        x = x.double()
    elif case == "columns":
        x = torch.zeros((8, 17))
    elif case == "column_stride":
        x = torch.zeros((16, 8)).T
    elif case == "one_dim":
        x = x[0]
    launches = pv.psd_valid.launches
    with pytest.raises(ValueError):
        pv._psd_valid_cuda(x, basis, TOL, False)
    assert pv.psd_valid.launches == launches


def test_empty_bank_launches_nothing(on_host):
    launches = pv.psd_valid.launches
    out = pv._psd_valid_cuda(torch.zeros((0, 16)), tt.pauli_basis(2), TOL,
                             False)
    assert out.shape == (0,) and out.dtype == torch.bool
    assert pv.psd_valid.launches == launches


@pytest.mark.parametrize("name", ["pauli1", "pauli2", "gm3", "gm5"])
def test_a_cpu_bank_keeps_the_plain_test(name):
    """On the host the model never reaches the kernel's wrapper."""
    basis = {"pauli1": lambda: tt.pauli_basis(1),
             "gm5": lambda: tt.gell_mann_basis(5), **BASES}[name]()
    x = torch.from_numpy(psd_valid_cases(basis, 512, 9))
    launches = pv.psd_valid.launches
    model = tt.TomographyModel(basis)
    ok = model.are_models_valid(x)
    assert pv.psd_valid.launches == launches
    if basis.dim > 2:
        assert torch.equal(ok, pv.psd_valid_plain(x, basis, TOL))
        assert torch.equal(ok, pv.psd_valid(x, basis, TOL))


@pytest.mark.parametrize("subnormalized", [False, True],
                         ids=["unit_trace", "subnormalized"])
@pytest.mark.parametrize("banks", [1, 3])
@pytest.mark.parametrize("name", list(BASES))
def test_redraw_kernel_source_matches_the_masked_chain(on_host, name, banks,
                                                       subnormalized):
    basis = BASES[name]()
    case = redraw_round_case(basis, 3 * 1400 + 3 * 77, banks, 5)
    launches = pv.psd_redraw.launches
    res = redraw_round_agreement(basis, case, subnormalized,
                                 redraw=pv._psd_redraw_cuda)
    assert pv.psd_redraw.launches == launches + 2
    # At d = 8 the one root's first smear leaves ≈ 90 % of the rows
    # invalid (a resample of the three-qubit cell tests ≈ 14 banks' rows).
    assert 0.2 * res["rows"] < res["mask"]["invalid_before"] < (
        (0.8 if basis.dim < 8 else 0.95) * res["rows"])
    for form in ("mask", "list"):
        r = res[form]
        assert r["decisive"] > 0.95 * r["invalid_before"]
        assert 0 < r["left"] < r["invalid_before"]
        # The smear rounds as the CPU's GEMM does up to its order of sums.
        assert r["max_ulps"] <= REDRAW_MAX_ULPS


def test_redraw_round_with_no_invalid_row_changes_nothing(on_host):
    basis = tt.pauli_basis(2)
    locs, ok, centers, roots, noise = redraw_round_case(basis, 600, 1, 6)
    ok[:] = True
    got, got_ok = locs.clone(), ok.clone()
    left, _ = pv._psd_redraw_cuda(got, got_ok, centers, roots[0], noise, 0,
                                  None, basis, TOL, False)
    assert int(left) == 0 and left.dtype == torch.int32
    assert torch.equal(got, locs) and bool(got_ok.all())


def test_redraw_wrapper_aligns_the_d8_rows_it_reads_as_float4(on_host):
    """The d = 8 round reads S and ε four floats at a time: noise and a
    root at an offset of one float reach the kernel as aligned copies, and
    the round writes what it writes from aligned ones."""
    basis = tt.pauli_basis(3)
    locs, ok, centers, roots, noise = redraw_round_case(basis, 300, 1, 12)
    n_bad = int((~ok).sum())
    want, want_ok = locs.clone(), ok.clone()
    pv._psd_redraw_cuda(want, want_ok, centers, roots[0], noise, n_bad,
                        None, basis, TOL, False)
    shifted_noise = torch.cat([torch.zeros(1), noise.flatten()])[1:]
    shifted_root = torch.cat([torch.zeros(1), roots[0].flatten()])[1:]
    assert shifted_noise.data_ptr() % 16 and shifted_root.data_ptr() % 16
    got, got_ok = locs.clone(), ok.clone()
    pv._psd_redraw_cuda(got, got_ok, centers, shifted_root.view(64, 64),
                        shifted_noise.view(300, 64), n_bad, None, basis, TOL,
                        False)
    assert torch.equal(got, want) and torch.equal(got_ok, want_ok)
    assert bool(got_ok.any()) and not bool(got_ok.all())


@pytest.mark.parametrize("case", ["qubit", "d5", "f64", "ragged_banks",
                                  "mask_dtype", "root_shape", "devices",
                                  "list_dtype", "list_length"])
def test_redraw_wrapper_refuses_what_the_kernel_cannot_take(on_host, case):
    basis = tt.pauli_basis(1) if case == "qubit" else (
        tt.gell_mann_basis(5) if case == "d5" else tt.pauli_basis(2))
    n_el = basis.n_elements
    locs, centers, noise = (torch.zeros((12, n_el)) for _ in range(3))
    ok, root = torch.zeros(12, dtype=torch.bool), torch.eye(n_el)
    rows = None
    if case == "list_dtype":
        rows = torch.arange(12)
    elif case == "list_length":
        rows = torch.arange(11, dtype=torch.int32)
    elif case == "f64":
        noise = noise.double()
    elif case == "ragged_banks":
        root = torch.eye(n_el).expand(5, n_el, n_el)
    elif case == "mask_dtype":
        ok = ok.to(torch.uint8)
    elif case == "root_shape":
        root = torch.eye(n_el + 1)
    elif case == "devices":
        centers = torch.zeros((12, n_el), device="meta")
    launches = pv.psd_redraw.launches
    with pytest.raises(ValueError):
        pv._psd_redraw_cuda(locs, ok, centers, root, noise, 12, rows, basis,
                            TOL, False)
    with pytest.raises(ValueError):  # the public wrapper: CUDA only
        pv.psd_redraw(locs, ok, centers, root, noise, 12, rows, basis, TOL)
    assert pv.psd_redraw.launches == launches


class _Draws:
    """The smear noise of a resample from a list, one call a draw, with the
    shapes asked for."""

    def __init__(self, draws):
        self.draws, self.shapes = draws, []

    def __call__(self, generator, shape):
        self.shapes.append(shape)
        return self.draws[len(self.shapes) - 1]


@pytest.mark.parametrize("banks", [1, 3])
@pytest.mark.parametrize("name", list(BASES))
def test_liu_west_loop_through_the_kernel_round(on_host, name, banks):
    """The resampler's loop with the kernel's round (the model's
    ``redraw_round`` on the host kernel) against its masked chain, the
    same draws: the same rounds, each drawing the whole bank once, the
    same rows taken (within the smear's rounding) and clamped, and the
    kernel's rows counted as tested."""
    import qinfer_tpu_torch as qt
    from qinfer_tpu_torch import resamplers

    basis = BASES[name]()
    model = tt.TomographyModel(basis)
    n = 900
    _, _, centers, roots, _ = redraw_round_case(basis, banks * n, banks, 8)
    g = torch.Generator().manual_seed(banks)
    draws = [torch.randn(banks * n, basis.n_elements, generator=g)
             for _ in range(7)]
    shape = (banks, n, basis.n_elements) if banks > 1 else (
        n, basis.n_elements)
    draws = [x.reshape(shape) for x in draws]
    centers = centers.reshape(shape)
    root = roots if banks > 1 else roots[0]

    def run(kernel_round):
        kernel = _Draws(draws)
        rs = qt.LiuWestResampler(maxiter=6, kernel=kernel)
        rounds = resamplers.LiuWestResampler.redraw_rounds
        kernel_rounds = resamplers.LiuWestResampler.kernel_rounds
        with pytest.MonkeyPatch.context() as mp:
            if kernel_round:
                mp.setattr(tt.TomographyModel, "redraw_round",
                           lambda self, device: functools.partial(
                               pv._psd_redraw_cuda, basis=self.basis,
                               psd_tol=self.psd_tol,
                               allow_subnormalized=self.allow_subnormalized))
            with profile(activities=[ProfilerActivity.CPU]):
                out = rs._postselect(qt.BinomialModel(model), None, centers,
                                     root)
        counters = profiling.recorded()["counters"]
        return (out, kernel.shapes,
                resamplers.LiuWestResampler.redraw_rounds - rounds,
                resamplers.LiuWestResampler.kernel_rounds - kernel_rounds,
                counters)

    want, want_shapes, want_rounds, plain_kernel_rounds, plain = run(False)
    got, shapes, rounds, kernel_rounds, counters = run(True)
    assert plain_kernel_rounds == 0 and kernel_rounds == rounds
    assert shapes == want_shapes == [shape] * (1 + rounds)
    assert 1 < rounds <= 6
    # No row of these draws lies within the smear's rounding of the
    # threshold, so both loops take the same rows in the same rounds.
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-6)
    tested = counters["resamplers.LiuWestResampler.tested_rows"]
    assert counters["ops.psd_valid.rows"] == tested - banks * n
    assert plain["resamplers.LiuWestResampler.tested_rows"] == (
        (1 + rounds) * banks * n)
    assert counters["resamplers.LiuWestResampler.kernel_rounds"] == rounds
