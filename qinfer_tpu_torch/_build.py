"""Build and bind the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain ``extern "C"``
interface, loaded with ``ctypes``. The library lands in
``build/qinfer_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources and the flags, so a changed source rebuilds and an unchanged
one is reused. Nothing here runs at import: the CPU tests import every
module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "check", "BUILD_ROOT", "SOURCES"]

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "fused_update.cu", _PKG / "csrc" / "resample_expand.cu")
BUILD_ROOT = _PKG.parent / "build" / "qinfer_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# name -> argtypes; every entry point returns its cudaGetLastError().
_SIGNATURES = {
    # (tile, scalars, log_w, cols (host array of device pointers), n_cols,
    #  out_lw, partials, n_blocks, stats, n, stream)
    "qt_fused_update": (_I32, _P, _P, _P, _I32, _P, _P, _I32, _P, _I64, _P),
    # (starts, n_in, values, n_cols, affine or NULL, out, n_out, stream)
    "qt_expand": (_P, _I64, _P, _I32, _P, _P, _I64, _P),
}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of qinfer_tpu_torch cannot be built"
    )


def _digest():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first call.

    Returns ``(lib, info)`` where ``info`` holds the library path, the build
    time in seconds (0.0 when a cached build was reused) and the compiler's
    register/shared-memory report. Raises when nvcc is missing or fails.
    """
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "libqinfer_tpu_torch.so"
    log = out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".tmp-{os.getpid()}.so"
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    report = log.read_text() if log.exists() else ""
    return lib, {"path": str(so), "seconds": seconds, "report": report}


def check(err, name):
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
