"""Build and bind the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain ``extern "C"``
interface, loaded with ``ctypes``. The library lands in
``build/qinfer_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources, the header and the flags, so a changed source rebuilds and an
unchanged one is reused.

A model that brings its own CUDA pr1 functor (``ops.fused_update.cuda_pr1``)
gets a library of its own, built at first use by ``user_library``: the
header ``csrc/fused_update.cuh``, the functor's source and the entry points
of both outcome compositions over it, compiled with the same flags into
``build/qinfer_tpu_torch/user/<hash of source, header and flags>/``.

Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "user_library", "user_translation_unit", "user_digest",
           "check", "BUILD_ROOT", "SOURCES", "HEADER", "USER_FUNCTOR"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
SOURCES = (_CSRC / "fused_update.cu", _CSRC / "resample_expand.cu")
HEADER = _CSRC / "fused_update.cuh"  # the B1 kernels, included by every B1 library
USER_FUNCTOR = "UserPr1"  # the struct a user functor's source defines
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
    # (outcome, pr1, scalars, scalar_stride, consts (host floats), n_consts,
    #  log_w, cols (host array of device pointers), col_strides (host
    #  int64s), n_cols, span_base, span_offsets (host int32s), span_stride
    #  (0: per-column path), trial_stride, out_lw, partials, n_blocks,
    #  stats, n, n_trials, grid_blocks (0: two-pass form), normalize, stream)
    "qt_fused_update": (_I32, _I32, _P, _I32, _P, _I32, _P, _P, _P, _I32,
                        _P, _P, _I32, _I64, _P, _P, _I32, _P, _I64, _I32,
                        _I32, _I32, _P),
    # (outcome, pr1, n_cols, n_trials, capacity (host int, written))
    "qt_fused_update_capacity": (_I32, _I32, _I32, _I32, _P),
    # (starts, n_in, values, n_cols, affine or NULL, out, n_out, n_trials,
    #  form, stream)
    "qt_expand": (_P, _I64, _P, _I32, _P, _P, _I64, _I32, _I32, _P),
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


def _digest(*parts):
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name, text in parts:
        h.update(name.encode())
        h.update(text)
    return h.hexdigest()[:16]


_LOCKS = {}  # build directory -> the lock its build holds


def _compile(out_dir, name, sources, names, include=()):
    """Compiles ``sources`` into ``out_dir/name`` unless it is there, loads
    it and binds ``names``. Returns ``(lib, info)`` where ``info`` holds the
    library path, the build time in seconds (0.0 when a cached build was
    reused) and the compiler's register/shared-memory report. Raises with
    nvcc's stderr when nvcc is missing or fails."""
    so = out_dir / name
    log = out_dir / "build.log"
    seconds = 0.0
    with _LOCKS.setdefault(str(out_dir), threading.Lock()):
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".tmp-{os.getpid()}.so"
            cmd = [_nvcc(), *_FLAGS, *(f"-I{d}" for d in include), "-o",
                   str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn_name in names:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(_SIGNATURES[fn_name])
        fn.restype = ctypes.c_int
    report = log.read_text() if log.exists() else ""
    return lib, {"path": str(so), "seconds": seconds, "report": report}


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first call: ``(lib, info)`` as
    ``_compile`` returns them."""
    digest = _digest(*((p.name, p.read_bytes()) for p in (*SOURCES, HEADER)))
    return _compile(BUILD_ROOT / digest, "libqinfer_tpu_torch.so", SOURCES,
                  _SIGNATURES)


def user_translation_unit(source):
    """The translation unit of a user functor's library: the B1 header, the
    functor's source (which defines ``struct UserPr1``) in the header's
    anonymous namespace, and the entry points of both outcome compositions
    over it."""
    body = source.strip("\n")
    return (f'#include "{HEADER.name}"\n\nnamespace {{\n\n{body}\n\n'
            f"}}  // namespace\n\nQT_FUSED_UPDATE_FUNCTOR({USER_FUNCTOR})\n")


def user_digest(source):
    """The cache key of a user functor's library: a hash of its source, the
    B1 header and the flags."""
    return _digest((HEADER.name, HEADER.read_bytes()),
                   ("source", source.encode()))


@functools.lru_cache(maxsize=None)
def user_library(source):
    """The loaded library of one user pr1 functor, built on its first call
    (``(lib, info)`` as ``library()``): every form of ``TwoOutcome<UserPr1>``
    and ``Binomial<UserPr1>`` behind ``qt_fused_update`` and
    ``qt_fused_update_capacity``, functor id 0. Raises with nvcc's message
    when the source does not compile; nothing falls back."""
    out_dir = BUILD_ROOT / "user" / user_digest(source)
    unit = out_dir / "user_pr1.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    unit.write_text(user_translation_unit(source))
    return _compile(out_dir, "libqinfer_tpu_torch_user.so", (unit,),
                  ("qt_fused_update", "qt_fused_update_capacity"),
                  include=(_CSRC,))


def check(err, name):
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
