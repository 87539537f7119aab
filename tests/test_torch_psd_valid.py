"""The validity kernel of d = 3, 4 tomography on the host (CPU).

- the route: the kernel only for CUDA banks at d = 3 and 4;
- the module imports, and a CPU bank is tested, on a host without nvcc;
- the kernel's source, built by the host's g++ (``-ffp-contract=off``, a
  stub header for the CUDA names, each block's threads run twice so that
  the second pass finds the staged tile whole) and called through the
  wrapper with host pointers: equal to the plain version on every row
  whose smallest eigenvalue (f64) is more than 1e-6 from −psd_tol, at
  unit row stride and at the diffusive model's stride d² + 1, with and
  without subnormalised states;
- the wrapper's checks, its launch count and its rows counter.
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qinfer_tpu_torch.tomography as tt
from qinfer_tpu_torch import _build, profiling
from qinfer_tpu_torch.ops import psd_valid as pv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402
    PSD_MARGIN as MARGIN,
    PSD_TOL as TOL,
    min_eigenvalues,
    psd_valid_cases,
)

BASES = {"pauli2": lambda: tt.pauli_basis(2),
         "gm3": lambda: tt.gell_mann_basis(3)}


@pytest.mark.parametrize("device_type,dim,kernel", [
    ("cuda", 3, True), ("cuda", 4, True), ("cuda", 2, False),
    ("cuda", 5, False), ("cuda", 8, False), ("cpu", 3, False),
    ("cpu", 4, False), ("cpu", 2, False)])
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


_STUB = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __global__
#define __launch_bounds__(x)
#define __shared__ static
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline void __syncthreads() {}
static inline float __ldg(const float* p) { return *p; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
#define QT_AT(b, t) (blockIdx.x = (b), threadIdx.x = (t))
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/psd_valid.cu built by g++: each launch runs its blocks in turn,
    each block's threads twice (the first pass stages the tile, the second
    finds it whole)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    source = (ROOT / "qinfer_tpu_torch" / "csrc" / "psd_valid.cu").read_text()
    source = source.replace("#include <cuda_runtime.h>", _STUB)
    source, n = re.subn(
        r"(\w+<D>)<<<(\w+), (\w+), 0, \w+>>>\(",
        r"for (unsigned bx = 0; bx < \2; ++bx) for (int pass = 0; pass < 2;"
        r" ++pass) for (int t = 0; t < \3; ++t) QT_AT(bx, t), \1(", source)
    assert n == 1
    folder = tmp_path_factory.mktemp("psd_valid")
    (folder / "psd_valid.cpp").write_text(source)
    lib = folder / "psd_valid.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib), str(folder / "psd_valid.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.qt_psd_valid.argtypes = list(_build._SIGNATURES["qt_psd_valid"])
    so.qt_psd_valid.restype = ctypes.c_int
    return so


class _Stream:
    cuda_stream = 0


@pytest.fixture
def on_host(monkeypatch, host_kernel):
    """The wrapper's CUDA path on host tensors, launching ``host_kernel``."""
    monkeypatch.setattr(_build, "library", lambda: (host_kernel, {}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _: _Stream())
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


def test_kernel_source_on_degenerate_rows(on_host):
    """Zeros, NaN, a pure state, the maximally mixed state, a trace just
    out of range and a row far outside, over two blocks, the second
    ragged."""
    basis = tt.pauli_basis(2)
    x = np.zeros((300, 16), np.float32)
    x[:, 0] = 0.5
    x[1] = 0.0
    x[2, 3] = np.nan
    x[3] = basis.state_to_modelparams(np.diag([1, 0, 0, 0])[None])[0].numpy()
    x[4, 0] = 0.5 + 2e-4
    x[299, 5] = 0.6
    got = pv._psd_valid_cuda(torch.from_numpy(x), basis, TOL, False)
    want = pv.psd_valid_plain(torch.from_numpy(x), basis, TOL, False)
    assert torch.equal(got, want)
    assert got[[0, 3, 5]].all() and not got[[1, 2, 4, 299]].any()


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
