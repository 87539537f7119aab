"""Systematic-resampling expand (kernel B2): wrapper and plain version.

Counterpart of ``qinfer_tpu/ops/resample_expand.py``:
``out[i] = values[j(i)] · scale + shift`` with
``j(i) = max{j : starts[j] ≤ i}`` over sorted segment starts. On a CUDA
tensor ``expand_sorted_segments`` launches the hand-written kernel in
``csrc/resample_expand.cu`` (its header says what bounds it and how it is
laid out); on a CPU tensor it runs ``expand_plain``, the same function in
plain PyTorch. The two agree bit for bit. A failed build or launch raises:
nothing falls back.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["expand_sorted_segments", "expand_plain", "systematic_expand"]


def _affine(scale, shift, n_cols, device):
    """(2, D) [scale; shift] rows, or None for the identity."""
    if scale is None and shift is None:
        return None
    def row(v, default):
        # Python numbers become a fill on the device, not a host copy.
        if v is None or isinstance(v, (int, float)):
            v = torch.full((), default if v is None else float(v),
                           device=device)
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).expand(n_cols)

    return torch.stack([row(scale, 1.0), row(shift, 0.0)]).contiguous()


def expand_plain(starts, values, n_out, affine=None):
    """Plain PyTorch version of the kernel on (n_in, D) values."""
    rows = torch.arange(n_out, dtype=starts.dtype, device=starts.device)
    idx = torch.clamp(
        torch.searchsorted(starts, rows, right=True) - 1, min=0
    )
    out = values[idx]
    if affine is not None:
        out = out * affine[0] + affine[1]
    return out


def _expand_cuda(starts, values, n_out, affine):
    device = values.device
    if starts.device != device:
        raise ValueError("starts and values must be on the same device")
    n_in, n_cols = values.shape
    if starts.shape != (n_in,) or n_in == 0:
        raise ValueError("starts must be (n_in,) with n_in == len(values) > 0")
    out = torch.empty((n_out, n_cols), dtype=torch.float32, device=device)
    if n_out == 0:
        return out
    lib, _ = _build.library()
    with torch.cuda.device(device):
        err = lib.qt_expand(
            starts.data_ptr(), n_in, values.data_ptr(), n_cols,
            None if affine is None else affine.data_ptr(),
            out.data_ptr(), n_out,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_expand")
    expand_sorted_segments.launches += 1
    return out


def expand_sorted_segments(starts, values, n_out=None, scale=None,
                           shift=None):
    """out[i] = values[j(i)] with j(i) = max{j : starts[j] ≤ i}.

    ``starts``: (n_in,) sorted non-decreasing with starts[0] == 0, taken as
    int32 (other integer or f32 dtypes are converted). ``values``: (n_in,)
    or (n_in, D). Returns matching (n_out[, D]) f32. ``scale``/``shift``:
    optional per-column affine applied at the write (the fused Liu–West
    shrinkage). Requires n_out < 2^24, as the JAX package does.
    """
    n_in = starts.shape[0]
    n_out = n_in if n_out is None else int(n_out)
    if n_out >= 1 << 24:
        raise ValueError("expand kernel requires n_out < 2^24 (f32 indices)")
    starts = starts.to(torch.int32).contiguous()
    values = values.to(torch.float32)
    squeeze = values.ndim == 1
    vals2d = (values[:, None] if squeeze else values).contiguous()
    affine = _affine(scale, shift, vals2d.shape[1], vals2d.device)
    if vals2d.is_cuda:
        out = _expand_cuda(starts, vals2d, n_out, affine)
    else:
        out = expand_plain(starts, vals2d, n_out, affine)
    return out[:, 0] if squeeze else out


expand_sorted_segments.launches = 0


def systematic_expand(log_w, values, scale=None, shift=None, u0=None,
                      generator=None):
    """values[idx] (optionally affine-transformed), idx ~ systematic(w).

    ``u0`` (the one stratum offset) is drawn from ``generator`` unless it
    is given.
    """
    from ..resamplers import systematic_segment_starts

    n = log_w.shape[0]
    starts = systematic_segment_starts(log_w, n, u0=u0, generator=generator)
    return expand_sorted_segments(starts, values, n_out=n, scale=scale,
                                  shift=shift)
