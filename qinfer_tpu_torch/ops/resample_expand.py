"""Systematic-resampling expand (kernel B2): wrapper and plain version.

Counterpart of ``qinfer_tpu/ops/resample_expand.py``:
``out[i] = values[j(i)] · scale + shift`` with
``j(i) = max{j : starts[j] ≤ i}`` over sorted segment starts. On a CUDA
tensor ``expand_sorted_segments`` launches the hand-written kernel in
``csrc/resample_expand.cu`` (its header says what bounds it and how it is
laid out); on a CPU tensor it runs ``expand_plain``, the same function in
plain PyTorch. The two agree bit for bit. The kernel has four forms,
chosen from D, the trial count and the bank's size by ``kernel_form``; each
wrapper counts its launches in all (``launches``) and by form
(``form_launches``). A failed build or launch raises: nothing falls back.
``expand_sorted_segments_batched`` does the same for T independent banks
in one launch (its plain version is ``expand_plain_batched``).
``liu_west_expand_batched`` is the bank form with the Liu–West resample's
prologue: from T banks' log-weights, rows and stratum offsets it computes
the moments, Σ^{1/2} at D = 1, the systematic starts and the shrunk rows in
one launch, on CUDA tensors only (its plain version is the eager chain it
replaces, ``LiuWestResampler._unfused_centers`` with the expand kernel
off); ``fused_liu_west_route`` says which banks it takes.

B2's input, the integer-quantized systematic segment starts
(``systematic_segment_starts[_batched]``), is computed here too; the
resamplers import it under the JAX package's names.
"""

from __future__ import annotations

import torch

from .. import _build
from ..profiling import count, span
from ..utils import cumsum_rows, normalize_log_weights

__all__ = ["expand_sorted_segments", "expand_plain", "systematic_expand",
           "expand_sorted_segments_batched", "expand_plain_batched",
           "fused_liu_west_route", "liu_west_expand_batched",
           "systematic_segment_starts", "systematic_segment_starts_batched"]

MAX_TRIALS = 65535  # gridDim.y of the kernel
ROWS, SPAN, MERGE, BANK = 0, 1, 2, 3  # the kernel's forms (csrc/resample_expand.cu)
FORM_NAMES = {ROWS: "rows", SPAN: "span", MERGE: "merge", BANK: "bank"}
BANK_CAP = 1 << 15       # starts a bank-form block stages (kBankCap)
BANK_THREADS = 512       # threads a bank-form block has (kBankThreads)
BANK_MAX_ROWS = 2048     # rows a bank-form block writes (kBankMaxRows)
BANK_SEARCH_ROWS = 256   # rows a searched tile writes, on launches of few blocks
BANK_SEARCH_BLOCKS = 264  # the most searched tiles a launch takes (two an SM of 132)
BANK_FEW = 12288         # the largest bank the bank form takes below MERGE_ITEMS
MERGE_ITEMS = 1 << 19    # merged items T·(n_in + n_out) from which the merge path is taken


# Weight-quantization scale of the integer CDF.
_CDF_QUANT = float(1 << 30)


def _check_n_draws(n_draws):
    if n_draws >= 1 << 24:
        raise ValueError(
            "systematic_segment_starts carries starts in f32 — exact only "
            f"for n_draws < 2^24 (got {n_draws})"
        )


def _starts_from_weights(w, n_draws, u0):
    """Segment starts over the last axis of normalized weights ``w``, with
    one stratum offset per row (``u0`` of the leading shape)."""
    device = w.device
    q = torch.round(w * _CDF_QUANT).to(torch.int64)
    icdf = torch.cumsum(q, dim=0) if q.ndim == 1 else cumsum_rows(q)
    total = torch.clamp(icdf[..., -1], min=1)
    scale = torch.full((), float(n_draws), device=device) / total.to(
        torch.float32)
    t = torch.ceil(icdf.to(torch.float32) * scale[..., None] - u0[..., None])
    starts = torch.cat([torch.zeros(t.shape[:-1] + (1,), dtype=torch.float32,
                                    device=device), t[..., :-1]], dim=-1)
    return torch.clamp(starts, min=0.0).to(torch.int32)


def _as_u0(u0, shape, generator, device):
    if u0 is None:
        u0 = torch.rand(shape, generator=generator, device=device)
    elif not isinstance(u0, torch.Tensor):
        u0 = torch.full(shape, float(u0), device=device)
    return u0.to(device=device, dtype=torch.float32).reshape(shape)


def systematic_segment_starts(log_w, n_draws, u0=None, generator=None):
    """Sorted int32 segment starts with starts[0] == 0.

    t_j = ceil(n·cdf_j − u0) counts the strata below cdf_j, so particle j
    covers output slots [t_{j−1}, t_j). The weights are quantized to
    integers (2⁻³⁰ granularity) and summed exactly, so the starts are
    sorted by construction. ``u0`` ~ U[0, 1) is drawn from ``generator``
    unless given (a float or a 0-d tensor).
    """
    _check_n_draws(n_draws)
    w = torch.exp(normalize_log_weights(log_w)[0])
    return _starts_from_weights(
        w, n_draws, _as_u0(u0, (), generator, log_w.device))


def systematic_segment_starts_batched(log_w, n_draws, u0=None,
                                      generator=None):
    """``systematic_segment_starts`` of each of T banks, ``log_w`` (T, N):
    (T, N) int32, one stratum offset per trial (``u0`` (T,), drawn from
    ``generator`` unless given)."""
    _check_n_draws(n_draws)
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=1, keepdim=True))
    return _starts_from_weights(
        w, n_draws, _as_u0(u0, (log_w.shape[0],), generator, log_w.device))


def kernel_form(n_cols, n_trials, n_in, n_out):
    """The kernel's form for D = ``n_cols`` on T = ``n_trials`` banks of
    ``n_in`` starts and ``n_out`` rows: a warp per span of 32 rows above
    D = 8; up to it, the bank form on banks of at most 2048 starts (a block
    a bank) at any T, the merge path on other launches from 2^19 merged
    items T·(n_in + n_out), the bank form again on banks of at most 12288
    starts, and one thread a row on the rest (a few banks of 12289 to 2^18
    starts). Measured on an H100 (``chip_profile.py --b2-forms``, PERF.md
    §6): the bank form beat the merge path from 74 to 1024 trials of 2048
    and the rows form on single banks of 2000 to 10000; the rows form beat
    both on a single bank of 16385 and of 2^17, the merge path both from
    one bank of 2^18."""
    if n_cols > 8:
        return SPAN
    if n_in <= BANK_MAX_ROWS:
        return BANK
    if n_trials * (n_in + n_out) >= MERGE_ITEMS:
        return MERGE
    return BANK if n_in <= BANK_FEW else ROWS


def bank_tiles(n_trials, n_out):
    """The bank form's blocks a trial: tiles of BANK_SEARCH_ROWS rows, each
    row searched by a thread of its own, while the launch has at most
    BANK_SEARCH_BLOCKS of them; else tiles of up to BANK_MAX_ROWS rows,
    scanned (a block a bank of 2048). On an H100 the searched tiles were
    the faster on 1 to 16 banks of 2048 and single banks of 2000 to 10000,
    the scanned on 74 to 1024 banks of 2048."""
    searched = -(-n_out // BANK_SEARCH_ROWS)
    if n_trials * searched <= BANK_SEARCH_BLOCKS:
        return searched
    return -(-n_out // BANK_MAX_ROWS)


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


def _expand_cuda_batched(starts, values, n_out, affine, form=None,
                         tiles=None):
    """Kernel B2 on T banks laid out back to back: ``starts`` int32 (T,
    n_in), ``values`` f32 (T, n_in, D), ``affine`` (T, 2, D) or None, all
    contiguous. ``form``: ROWS, SPAN, MERGE (D ≤ 8) or BANK (D ≤ 8, n_in ≤
    BANK_CAP), ``kernel_form``'s by default; ``tiles``: the bank form's
    blocks a trial (``bank_tiles``'s by default, each of at most
    BANK_MAX_ROWS rows). A form or tiling that these inputs do not allow
    raises ValueError; nothing takes another form.
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
    if form is None:
        form = kernel_form(n_cols, n_trials, n_in, n_out)
    if form not in FORM_NAMES or (form in (MERGE, BANK) and n_cols > 8):
        raise ValueError(f"no expand form {form} at D = {n_cols}")
    if form == BANK:
        if n_in > BANK_CAP:
            raise ValueError(f"the bank form stages at most {BANK_CAP} starts "
                             f"a block; got n_in = {n_in}")
        tiles = bank_tiles(n_trials, n_out) if tiles is None else int(tiles)
        if n_out > 0 and not (-(-n_out // BANK_MAX_ROWS) <= tiles <= n_out):
            raise ValueError(f"the bank form writes at most {BANK_MAX_ROWS} "
                             f"rows a block: {tiles} tiles of {n_out} rows")
    out = torch.empty((n_trials, n_out, n_cols), dtype=torch.float32,
                      device=device)
    if n_out == 0:
        return out
    lib, _ = _build.library()
    with torch.cuda.device(device):
        err = lib.qt_expand(
            starts.data_ptr(), n_in, values.data_ptr(), n_cols,
            None if affine is None else affine.data_ptr(),
            out.data_ptr(), n_out, n_trials, form,
            tiles if form == BANK else 0,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_expand")
    return out


def _expand_cuda(starts, values, n_out, affine):
    """Kernel B2 on one bank: (n_in,) starts, (n_in, D) values, (2, D)
    affine or None. Returns (n_out, D)."""
    return _launch(expand_sorted_segments, starts[None], values[None], n_out,
                   None if affine is None else affine[None])[0]


def _launch(wrapper, starts, values, n_out, affine):
    """Kernel B2 on T banks in ``kernel_form``'s form, counted on
    ``wrapper`` in all and under its form."""
    n_trials, n_in, n_cols = values.shape
    form = kernel_form(n_cols, n_trials, n_in, n_out)
    out = _expand_cuda_batched(starts, values, n_out, affine, form=form)
    wrapper.launches += 1
    wrapper.form_launches[FORM_NAMES[form]] += 1
    if torch.autograd._profiler_enabled():  # the counters count only then
        count(f"ops.{wrapper.__name__}.launches")
        count(f"ops.{wrapper.__name__}.form_launches.{FORM_NAMES[form]}")
    return out


def reset_form_launches():
    """Sets the B2 wrappers' launch counters, in all and by form, to 0."""
    for wrapper in (expand_sorted_segments, expand_sorted_segments_batched):
        wrapper.launches = 0
        wrapper.form_launches = dict.fromkeys(FORM_NAMES.values(), 0)
    liu_west_expand_batched.launches = 0


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
    with span("qinfer.ops.b2"):
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
expand_sorted_segments.form_launches = dict.fromkeys(FORM_NAMES.values(), 0)


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
    with span("qinfer.ops.b2"):
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
            out = _launch(expand_sorted_segments_batched, starts, vals3d,
                          n_out, affine)
        else:
            out = expand_plain_batched(starts, vals3d, n_out, affine)
        return out[:, :, 0] if squeeze else out


expand_sorted_segments_batched.launches = 0
expand_sorted_segments_batched.form_launches = dict.fromkeys(
    FORM_NAMES.values(), 0)


def systematic_expand(log_w, values, scale=None, shift=None, u0=None,
                      generator=None):
    """values[idx] (optionally affine-transformed), idx ~ systematic(w).

    ``u0`` (the one stratum offset) is drawn from ``generator`` unless it
    is given.
    """
    n = log_w.shape[0]
    with span("qinfer.ops.b2"):
        starts = systematic_segment_starts(log_w, n, u0=u0,
                                           generator=generator)
        return expand_sorted_segments(starts, values, n_out=n, scale=scale,
                                      shift=shift)


def fused_liu_west_route(device_type, n_rows, n_cols):
    """Whether ``liu_west_expand_batched`` takes T banks of ``n_rows`` ×
    ``n_cols`` on a device of ``device_type``: on CUDA, banks of 1 to
    BANK_MAX_ROWS rows (a block a bank) and at most 8 columns."""
    return (device_type == "cuda" and 1 <= n_rows <= BANK_MAX_ROWS
            and 1 <= n_cols <= 8)


def _liu_west_cuda(log_w, values, u0, a, h, zero_cov_comp):
    """The kernel on T banks: ``log_w`` f32 (T, N), ``values`` f32 (T, N,
    D), ``u0`` f32 (T,), all contiguous. Raises ValueError on what it does
    not take."""
    n_trials, n, n_cols = values.shape
    if not (1 <= n <= BANK_MAX_ROWS and 1 <= n_cols <= 8):
        raise ValueError(f"the fused Liu–West expand takes banks of 1 to "
                         f"{BANK_MAX_ROWS} rows and 1 to 8 columns; got "
                         f"({n}, {n_cols})")
    if log_w.shape != (n_trials, n) or u0.shape != (n_trials,):
        raise ValueError("log_w must be (T, N) and u0 (T,) for values (T, N, "
                         "D)")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != values.device for t in (log_w, values, u0)):
        raise ValueError("the fused Liu–West expand takes contiguous f32 "
                         "tensors on one device")
    device = values.device
    out = torch.empty_like(values)
    mean = torch.empty((n_trials, n_cols), dtype=torch.float32, device=device)
    cov = torch.empty((n_trials, n_cols, n_cols), dtype=torch.float32,
                      device=device)
    root = (torch.empty((n_trials, 1, 1), dtype=torch.float32, device=device)
            if n_cols == 1 else None)
    lib, _ = _build.library()
    with torch.cuda.device(device):
        err = lib.qt_liu_west_expand(
            log_w.data_ptr(), n, values.data_ptr(), n_cols, u0.data_ptr(),
            float(a), float(1.0 - a), float(h * h), float(zero_cov_comp),
            out.data_ptr(), mean.data_ptr(), cov.data_ptr(),
            None if root is None else root.data_ptr(), n_trials,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "qt_liu_west_expand")
    return out, mean, cov, root


def liu_west_expand_batched(log_w, values, u0, a, h, zero_cov_comp=0.0):
    """The Liu–West resample's centres of T banks in one launch of kernel
    B2's bank form, which computes its own inputs: per bank the weighted
    mean μ and covariance Σ (+ ``zero_cov_comp``·I) from ``log_w`` (T, N),
    the systematic starts from the same weights and ``u0`` (T,), and the
    rows a·x[j(i)] + (1 − a)·μ of ``values`` (T, N, D). Banks of at most
    2048 rows and 8 columns (``fused_liu_west_route``). Returns (centres
    (T, N, D), μ (T, D), Σ (T, D, D), h·Σ^{1/2} (T, 1, 1) at D = 1, else
    None). CUDA tensors only: the plain version is the resampler's eager
    chain, which a CPU bank takes."""
    with span("qinfer.ops.b2"):
        if not values.is_cuda:
            raise ValueError("liu_west_expand_batched launches on CUDA "
                             "tensors only")
        out = _liu_west_cuda(
            log_w.to(torch.float32).contiguous(),
            values.to(torch.float32).contiguous(),
            u0.to(torch.float32).contiguous(), a, h, zero_cov_comp)
        liu_west_expand_batched.launches += 1
        count("ops.liu_west_expand_batched.launches")
        return out


liu_west_expand_batched.launches = 0
