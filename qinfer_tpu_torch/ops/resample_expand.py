"""Systematic-resampling expand (kernel B2): wrapper and plain version.

Counterpart of ``qinfer_tpu/ops/resample_expand.py``:
``out[i] = values[j(i)] · scale + shift`` with
``j(i) = max{j : starts[j] ≤ i}`` over sorted segment starts. On a CUDA
tensor ``expand_sorted_segments`` launches the hand-written kernel in
``csrc/resample_expand.cu`` (its header says what bounds it and how it is
laid out); on a CPU tensor it runs ``expand_plain``, the same function in
plain PyTorch. The two agree bit for bit. The kernel has three forms,
chosen from D and the launch's size by ``kernel_form``. A failed build or launch raises:
nothing falls back. ``expand_sorted_segments_batched`` does the same for T
independent banks in one launch (its plain version is
``expand_plain_batched``).
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["expand_sorted_segments", "expand_plain", "systematic_expand",
           "expand_sorted_segments_batched", "expand_plain_batched"]

MAX_TRIALS = 65535  # gridDim.y of the kernel
ROWS, SPAN, MERGE = 0, 1, 2  # the kernel's forms (csrc/resample_expand.cu)


def kernel_form(n_cols, n_items):
    """The kernel's form for D = ``n_cols`` on a launch that merges
    ``n_items`` = T·(n_in + n_out) starts and rows: a warp per span of 32
    rows above D = 8; below, the merge path from 2^19 items, one thread per
    row on fewer, where the merge path's per-block search is not amortised.
    Each choice is the faster form on an H100 at the paths' shapes
    (``chip_profile.py --b2-forms``, PERF.md §6): 2^20 rows at every D,
    256 trials of 2048, one trial of 2^18 (ensemble_big's resample) and 74
    trials of 2048 (ensemble_small's, where one thread a row wins)."""
    if n_cols > 8:
        return SPAN
    return MERGE if n_items >= 1 << 19 else ROWS


def _affine(scale, shift, n_cols, device):
    """(2, D) [scale; shift] rows, or None for the identity."""
    affine = _affine_batched(scale, shift, 1, n_cols, device)
    return None if affine is None else affine[0]


def expand_plain(starts, values, n_out, affine=None):
    """Plain PyTorch version of the kernel on (n_in, D) values."""
    return expand_plain_batched(starts[None], values[None], n_out,
                                None if affine is None else affine[None])[0]


def expand_plain_batched(starts, values, n_out, affine=None):
    """Plain PyTorch version of the kernel on T banks: ``starts`` (T,
    n_in), ``values`` (T, n_in, D), ``affine`` (T, 2, D) or None."""
    n_trials, _, n_cols = values.shape
    rows = torch.arange(n_out, dtype=starts.dtype, device=starts.device)
    idx = torch.clamp(torch.searchsorted(
        starts, rows.expand(n_trials, n_out).contiguous(), right=True) - 1,
        min=0)
    out = torch.gather(values, 1,
                       idx.to(torch.int64)[:, :, None].expand(-1, -1, n_cols))
    if affine is not None:
        out = out * affine[:, 0:1] + affine[:, 1:2]
    return out


def _expand_cuda_batched(starts, values, n_out, affine, form=None):
    """Kernel B2 on T banks laid out back to back: ``starts`` int32 (T,
    n_in), ``values`` f32 (T, n_in, D), ``affine`` (T, 2, D) or None, all
    contiguous. ``form``: ROWS, SPAN or MERGE (D ≤ 8), ``kernel_form``'s
    by default.
    Returns (T, n_out, D)."""
    device = values.device
    if starts.device != device:
        raise ValueError("starts and values must be on the same device")
    n_trials, n_in, n_cols = values.shape
    if starts.shape != (n_trials, n_in) or n_in == 0:
        raise ValueError("starts must be (T, n_in) with n_in == len(values) > 0")
    if (starts.dtype != torch.int32 or values.dtype != torch.float32
            or not starts.is_contiguous() or not values.is_contiguous()
            or (affine is not None and not affine.is_contiguous())):
        raise ValueError("the expand kernel takes contiguous int32 starts, "
                         "f32 values and f32 affine")
    if n_trials > MAX_TRIALS:
        raise ValueError(f"the expand kernel takes at most {MAX_TRIALS} "
                         f"trials; got {n_trials}")
    out = torch.empty((n_trials, n_out, n_cols), dtype=torch.float32,
                      device=device)
    if n_out == 0:
        return out
    lib, _ = _build.library()
    with torch.cuda.device(device):
        err = lib.qt_expand(
            starts.data_ptr(), n_in, values.data_ptr(), n_cols,
            None if affine is None else affine.data_ptr(),
            out.data_ptr(), n_out, n_trials,
            kernel_form(n_cols, n_trials * (n_in + n_out)) if form is None
            else form,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_expand")
    return out


def _expand_cuda(starts, values, n_out, affine):
    """Kernel B2 on one bank: (n_in,) starts, (n_in, D) values, (2, D)
    affine or None. Returns (n_out, D)."""
    out = _expand_cuda_batched(
        starts[None], values[None], n_out,
        None if affine is None else affine[None])[0]
    expand_sorted_segments.launches += 1
    return out


def _check_n_out(n_out):
    if n_out >= 1 << 24:
        raise ValueError("expand kernel requires n_out < 2^24 (f32 indices)")


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
    _check_n_out(n_out)
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


def _affine_batched(scale, shift, n_trials, n_cols, device):
    """(T, 2, D) [scale; shift] per trial, or None for the identity; each
    of ``scale``/``shift`` is a number, a (D,) or a (T, D) tensor."""
    if scale is None and shift is None:
        return None

    def rows(v, default):
        # Python numbers become a fill on the device, not a host copy.
        if v is None or isinstance(v, (int, float)):
            v = torch.full((), default if v is None else float(v),
                           device=device)
        return torch.as_tensor(v, dtype=torch.float32, device=device).expand(
            n_trials, n_cols)

    return torch.stack([rows(scale, 1.0), rows(shift, 0.0)], dim=1).contiguous()


def expand_sorted_segments_batched(starts, values, n_out=None, scale=None,
                                   shift=None):
    """``expand_sorted_segments`` on T independent banks in one launch.

    The counterpart of the JAX package's ``sequential_vmap`` over the
    expand kernel. ``starts``: (T, n_in); ``values``: (T, n_in) or (T,
    n_in, D); ``scale``/``shift``: a number, (D,) or (T, D) (μ differs per
    trial). Returns (T, n_out[, D]); each trial's rows are bit-equal to
    ``expand_sorted_segments`` on that trial. At most 65535 trials.
    """
    n_trials, n_in = starts.shape
    if n_trials > MAX_TRIALS:
        raise ValueError(f"the expand kernel takes at most {MAX_TRIALS} "
                         f"trials; got {n_trials}")
    n_out = n_in if n_out is None else int(n_out)
    _check_n_out(n_out)
    starts = starts.to(torch.int32).contiguous()
    values = values.to(torch.float32)
    squeeze = values.ndim == 2
    vals3d = (values[:, :, None] if squeeze else values).contiguous()
    affine = _affine_batched(scale, shift, n_trials, vals3d.shape[2],
                             vals3d.device)
    if vals3d.is_cuda:
        out = _expand_cuda_batched(starts, vals3d, n_out, affine)
        expand_sorted_segments_batched.launches += 1
    else:
        out = expand_plain_batched(starts, vals3d, n_out, affine)
    return out[:, :, 0] if squeeze else out


expand_sorted_segments_batched.launches = 0


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
