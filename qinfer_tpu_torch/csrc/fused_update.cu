// Fused Bayes update (B1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel qinfer_tpu/ops/fused_update.py:36
// (_update_kernel, launched at :156 by fused_bayes_update). For a pluggable
// likelihood tile it computes, in one read of the bank,
//     lw_i = log_w_i + max(log L_i, -87)            (written out unnormalized)
//     lse  = log Σ exp(lw),   lse2 = log Σ exp(2·lw),   ess = exp(2·lse − lse2)
//
// What bounds it on this card: memory. Per particle it reads log_w and one
// parameter column and writes lw: 12 bytes, about 4 µs for 2^20 particles at
// 3.35 TB/s; the cos/log/exp per element are far below the SMs' rate. At
// that size the two launches cost as much as the traffic.
//
// Design. The TPU kernel walks a sequential grid and carries (m, s, m2, s2)
// across steps in SMEM; Hopper blocks run in parallel and in no order, so:
//   pass 1: each block grid-strides over the bank with an online
//           log-sum-exp per thread, reduces it over the block (warp
//           shuffles, then one warp), and writes one partial (m, s, s2);
//   pass 2: one block merges the partials in a fixed order (strided per
//           thread, then the same fixed tree) and writes the statistics.
// No atomics: the result is the same from run to run. The second sum reuses
// the first's exponential (Σ e², with the max of 2·lw equal to 2·max lw), as
// the TPU kernel does. The ragged tail is masked by the loop bound instead of
// being padded. `scalars` stays a device pointer (the TPU kernel's SMEM ref),
// so the caller feeds the outcome and t without a host sync.
//
// The likelihood is a device functor; PrecessionTwoOutcomeTile is
// two_outcome_tile(precession_pr1) (fused_update.py:247-256, 280-283). Its
// products are rounded one by one (no FMA contraction), as the plain
// PyTorch version of the same function computes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
constexpr float kNegBig = -3.0e38f;
constexpr float kLogTiny = -87.0f;

struct Cols {
  const float* p[kMaxCols];
};

// scalars = [outcome, t]; one column, omega.
// pr1 = 1 − cos²(0.5·ω·t); pr = outcome == 1 ? pr1 : 1 − pr1; log(max(pr, 1e-35)).
struct PrecessionTwoOutcomeTile {
  static constexpr int kNumCols = 1;
  float outcome, t;

  __device__ explicit PrecessionTwoOutcomeTile(const float* scalars)
      : outcome(scalars[0]), t(scalars[1]) {}

  __device__ __forceinline__ float operator()(const Cols& cols, int64_t i) const {
    const float c = cosf(__fmul_rn(__fmul_rn(0.5f, cols.p[0][i]), t));
    const float pr1 = __fsub_rn(1.0f, __fmul_rn(c, c));
    const float pr = (outcome == 1.0f) ? pr1 : __fsub_rn(1.0f, pr1);
    return logf(pr < 1e-35f ? 1e-35f : pr);
  }
};

// Online log-sum-exp state: m = max lw, s = Σ exp(lw − m), s2 = Σ exp(2lw − 2m).
struct Lse {
  float m, s, s2;
};

__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  const float m = fmaxf(a.m, b.m);
  const float ra = expf(a.m - m);
  const float rb = expf(b.m - m);
  Lse r;
  r.m = m;
  r.s = a.s * ra + b.s * rb;
  r.s2 = a.s2 * (ra * ra) + b.s2 * (rb * rb);
  return r;
}

__device__ __forceinline__ void lse_push(Lse& st, float lw) {
  if (lw > st.m) {
    const float r = expf(st.m - lw);
    st.s = st.s * r + 1.0f;
    st.s2 = st.s2 * (r * r) + 1.0f;
    st.m = lw;
  } else {
    const float e = expf(lw - st.m);
    st.s += e;
    st.s2 += e * e;
  }
}

__device__ __forceinline__ Lse warp_reduce(Lse v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lse o;
    o.m = __shfl_down_sync(0xffffffffu, v.m, off);
    o.s = __shfl_down_sync(0xffffffffu, v.s, off);
    o.s2 = __shfl_down_sync(0xffffffffu, v.s2, off);
    v = lse_merge(v, o);
  }
  return v;  // lane 0 holds the warp's total
}

// Fixed-order block reduction; thread 0 gets the total. blockDim.x == kThreads.
__device__ Lse block_reduce(Lse v) {
  __shared__ Lse warp_tot[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_tot[lane] : Lse{kNegBig, 0.0f, 0.0f};
    v = warp_reduce(v);
  }
  return v;
}

template <class Tile>
__global__ void __launch_bounds__(kThreads)
fused_update_pass1(const float* __restrict__ scalars,
                   const float* __restrict__ log_w, Cols cols,
                   float* __restrict__ out_lw, float* __restrict__ partials,
                   int64_t n) {
  const Tile tile(scalars);
  Lse st{kNegBig, 0.0f, 0.0f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float log_l = tile(cols, i);
    const float lw = __fadd_rn(log_w[i], log_l < kLogTiny ? kLogTiny : log_l);
    out_lw[i] = lw;
    lse_push(st, lw);
  }
  st = block_reduce(st);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = st.m;
    partials[3 * blockIdx.x + 1] = st.s;
    partials[3 * blockIdx.x + 2] = st.s2;
  }
}

// stats = [lse, lse2, log_norm (= lse), ess].
__global__ void __launch_bounds__(kThreads)
fused_update_pass2(const float* __restrict__ partials, int n_blocks,
                   float* __restrict__ stats) {
  Lse st{kNegBig, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    st = lse_merge(st, Lse{partials[3 * b], partials[3 * b + 1], partials[3 * b + 2]});
  }
  st = block_reduce(st);
  if (threadIdx.x == 0) {
    const float lse = st.m + logf(st.s);
    const float lse2 = 2.0f * st.m + logf(st.s2);
    stats[0] = lse;
    stats[1] = lse2;
    stats[2] = lse;
    stats[3] = expf(-(lse2 - 2.0f * lse));
  }
}

}  // namespace

// tile: 0 = PrecessionTwoOutcomeTile. cols: host array of n_cols device
// pointers. partials: 3·n_blocks floats; stats: 4 floats. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int qt_fused_update(int tile, const void* scalars, const void* log_w,
                               const void* const* cols, int n_cols, void* out_lw,
                               void* partials, int n_blocks, void* stats,
                               int64_t n, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || n_blocks <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Cols c{};
  for (int k = 0; k < n_cols; ++k) c.p[k] = static_cast<const float*>(cols[k]);
  const float* sc = static_cast<const float*>(scalars);
  const float* lw = static_cast<const float*>(log_w);
  float* out = static_cast<float*>(out_lw);
  float* part = static_cast<float*>(partials);
  switch (tile) {
    case 0:
      if (n_cols != PrecessionTwoOutcomeTile::kNumCols) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      fused_update_pass1<PrecessionTwoOutcomeTile>
          <<<n_blocks, kThreads, 0, s>>>(sc, lw, c, out, part, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_update_pass2<<<1, kThreads, 0, s>>>(part, n_blocks, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}
