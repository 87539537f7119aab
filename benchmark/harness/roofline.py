"""The yardstick of the kernels: the chip's peak and the bytes each call
needs, counted from the cell's shapes and the calls it makes (each input
byte read once, each output byte written once), never from a kernel's
arguments. A later kernel that does the same work reads against the same
bound.

The formulas are those of the repository's on-chip smoke script, whose
bound column is bytes over 3.35 TB/s.
"""

from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM, data sheet): HBM3 bandwidth, bytes/s. Both
# kernels are bound by memory: a Bayes update does a few flops a byte.
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
I32 = 4


def b1_bytes(rows, n_cols):
    """One Bayes update (kernel B1) of ``rows`` particles whose likelihood
    reads ``n_cols`` f32 parameter columns: the log-weights and the columns
    read, the new log-weights written."""
    return rows * (F32 + n_cols * F32 + F32)


def b2_bytes(n_in, n_out, d):
    """One systematic expand (kernel B2) of one bank: ``n_in`` int32 segment
    starts read and ``n_out`` rows of ``d`` f32 values written. The rows
    read depend on the weights (only the picked ones need reading, and
    they are unknown from the shapes), so they are not counted: the bound
    is never above what the call needs."""
    return n_in * I32 + n_out * d * F32


def least_seconds(nbytes):
    return nbytes / PEAK_BYTES_PER_S
