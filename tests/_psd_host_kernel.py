"""``qinfer_tpu_torch/csrc/psd_valid.cu`` built by the host's g++, and the
wrappers' CUDA path pointed at it, for tests on the CPU.

The build replaces the CUDA names by a stub header and each launch by a
loop over its blocks and threads: each block's threads of the validity
test run twice (the first pass stages the tile, the second finds it
whole), of the redraw round once. ``-ffp-contract=off`` keeps the
kernel's roundings. Used by ``tests/test_torch_psd_valid.py`` and by the
gloo worker of ``tests/test_torch_parallel.py``.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from qinfer_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent

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
struct alignas(16) float4 { float x, y, z, w; };
static inline float __ldg(const float* p) { return *p; }
static inline float4 __ldg(const float4* p) { return *p; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline int atomicAdd(int* p, int v) { int old = *p; *p += v; return old; }
static inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}
#define __grid_constant__
#define __device__
#define __host__
#define __forceinline__ inline
#define QT_AT(b, t) (blockIdx.x = (b), threadIdx.x = (t))
"""


def build(folder):
    """The library built into ``folder``, its entry points typed as
    ``_build._SIGNATURES`` types them; None without a host g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    source = (ROOT / "qinfer_tpu_torch" / "csrc" / "psd_valid.cu").read_text()
    source = source.replace("#include <cuda_runtime.h>", _STUB)
    source, n = re.subn(
        r"((\w+)<D>)<<<(\w+), (\w+), 0, \w+>>>\(",
        lambda m: (f"for (unsigned bx = 0; bx < {m[3]}; ++bx) for (int pass "
                   f"= 0; pass < {2 if m[2] == 'psd_valid_rows' else 1}; "
                   f"++pass) for (int t = 0; t < {m[4]}; ++t) QT_AT(bx, t), "
                   f"{m[1]}("), source)
    assert n == 2
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "psd_valid.cpp").write_text(source)
    lib = folder / "psd_valid.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib), str(folder / "psd_valid.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    for name in ("qt_psd_valid", "qt_psd_redraw"):
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
        getattr(so, name).restype = ctypes.c_int
    return so


class _Stream:
    cuda_stream = 0


def patches(lib):
    """(object, attribute, value) that point the wrappers' CUDA path, on
    host tensors, at ``lib``."""
    return ((_build, "library", lambda: (lib, {})),
            (torch.cuda, "device", lambda _: contextlib.nullcontext()),
            (torch.cuda, "current_stream", lambda _: _Stream()))


@contextlib.contextmanager
def on_host(lib):
    """``patches(lib)`` while the block runs."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches(lib)]
    try:
        for obj, name, value in patches(lib):
            setattr(obj, name, value)
        yield lib
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
