// Systematic-resampling expand (B2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel qinfer_tpu/ops/resample_expand.py:115
// (_expand_kernel, launched at :361 by _expand_cols). It computes
//     out[i, d] = values[j(i), d] · scale_d + shift_d,   j(i) = max{j : starts[j] ≤ i}
// for sorted int32 starts with starts[0] == 0; the affine is the fused
// Liu–West shrinkage a·x + (1 − a)·μ, and is skipped when `affine` is NULL.
// n_out may be less than n_in (the caller shifts the starts to its window).
//
// What bounds it on this card: memory. Per output row it reads one start
// and D values and writes D values, 4·(D+1) + 4·D bytes, about 12 MB for
// 2^20 rows at D = 1 (about 4 µs at 3.35 TB/s). The binary search reads
// ~20 starts per row, but the 4 MB of starts sits in the 50 MB L2 cache.
//
// Design: one thread per output row, a binary search upper_bound(starts, i)
// − 1, then a direct read of the row's D values with the affine applied at
// the write. None of the TPU kernel's machinery carries over: the DMA ring,
// the bf16 plane splits, the MXU one-hot selects and the shifted value
// streams all work around Mosaic (see that module's docstring). The affine
// is rounded as a product and then a sum (no FMA contraction), exactly as
// the plain PyTorch version computes it, so the two agree bit for bit.
//
// Trials. T independent banks (the JAX package's sequential_vmap,
// resample_expand.py:359, which runs the kernel once per trial) are one
// launch on a (row block, trial) grid: blockIdx.y picks the trial's starts,
// values, affine (μ differs per trial) and output rows. A single bank is
// T = 1, where blockIdx.y is 0 and nothing moves. gridDim.y bounds T at
// 65535.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ starts, int64_t n_in,
              const float* __restrict__ values, int n_cols,
              const float* __restrict__ affine, float* __restrict__ out,
              int64_t n_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t y = blockIdx.y;
  starts += y * n_in;
  values += y * n_in * n_cols;
  out += y * n_out * n_cols;
  if (affine != nullptr) affine += y * 2 * n_cols;
  // First k with starts[k] > i (ties resolve to the last j with starts[j] <=
  // i), by halving a (first, count) range. The probe is a pointer step, so
  // the trial's offset is added once and not in every probe's address.
  const int32_t* first = starts;
  int64_t count = n_in;
  while (count > 0) {
    const int64_t half = count >> 1;
    if (static_cast<int64_t>(__ldg(first + half)) <= i) {
      first += half + 1;
      count -= half + 1;
    } else {
      count = half;
    }
  }
  const int64_t lo = first - starts;
  const int64_t j = lo > 0 ? lo - 1 : 0;
  const float* src = values + j * n_cols;
  float* dst = out + i * n_cols;
  for (int d = 0; d < n_cols; ++d) {
    float v = __ldg(src + d);
    if (affine != nullptr) {
      v = __fadd_rn(__fmul_rn(v, __ldg(affine + d)), __ldg(affine + n_cols + d));
    }
    dst[d] = v;
  }
}

}  // namespace

// n_trials banks, each: starts int32 (n_in,); values f32 (n_in, n_cols)
// row-major; affine f32 (2, n_cols) [scale; shift] or NULL; out f32 (n_out,
// n_cols). The banks lie back to back (trial y's arrays start y times their
// size after trial 0's). Returns the cudaError_t of the launch (0 on success).
extern "C" int qt_expand(const void* starts, int64_t n_in, const void* values,
                         int n_cols, const void* affine, void* out, int64_t n_out,
                         int n_trials, void* stream) {
  if (n_in <= 0 || n_cols <= 0 || n_out <= 0 || n_trials <= 0 || n_trials > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_trials));
  expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), n_in, static_cast<const float*>(values),
      n_cols, static_cast<const float*>(affine), static_cast<float*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}
