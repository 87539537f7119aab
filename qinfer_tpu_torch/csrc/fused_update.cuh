// Fused Bayes update (B1) for Hopper, sm_90a: the kernels and their launch,
// for any pr1 functor.
//
// Replaces the Pallas TPU kernel qinfer_tpu/ops/fused_update.py:36
// (_update_kernel, launched at :156 by fused_bayes_update), which takes any
// pr1 tile a model supplies (:239-245). Two libraries include this header:
// the built-in one (fused_update.cu: the port's nine functors and the
// column route's GivenPr1, behind a functor switch) and, per model that
// brings its own CUDA functor, a library of that functor alone, built at
// first use (qinfer_tpu_torch/_build.py: user_library). For a pluggable
// likelihood tile it computes, in one read of the bank,
//     lw_i = log_w_i + max(log L_i, -87)            (written out unnormalized)
//     lse  = log Σ exp(lw),   lse2 = log Σ exp(2·lw),   ess = exp(2·lse − lse2)
//
// What bounds it on this card. Per particle it reads log_w and one to
// sixty-four parameter columns and writes lw: 12 to 264 bytes, 3.8 to
// 82.6 µs for 2^20 particles at 3.35 TB/s. At one to four columns the math
// costs as much: the accurate cos, log and exp that keep the plain version's
// bits take about a hundred instructions a particle (cuobjdump of the
// precession tile), so a pass over the bank runs well below the memory's
// rate, and every launch, merge and extra round trip of the bank adds to
// it.
//
// Design. The TPU kernel walks a sequential grid and carries (m, s, m2, s2)
// across steps in SMEM; Hopper blocks run in parallel and in no order. The
// schedule is therefore one of n_blocks (virtual) blocks:
//   partials: virtual block b, thread t takes rows b·256 + t + k·n_blocks·256
//             with an online log-sum-exp per thread, reduces it over the
//             block (warp shuffles, then one warp), and writes one partial
//             (m, s, s2);
//   merge:    the partials are merged in a fixed order (strided per thread,
//             then the same fixed tree) into the statistics.
// It runs in one of two forms, chosen by the wrapper (ops/fused_update.py:
// grid_plan) and giving the same bits:
//   two-pass (fused_update_pass1, then fused_update_pass2): one physical
//           block per virtual block writes its raw lw and its partial; a
//           second launch merges; the wrapper subtracts lse. The bank's
//           log-weights cross device memory three times (written raw, read
//           back, written normalised) in three launches;
//   one launch (fused_update_one): G physical blocks a trial each walk the
//           virtual blocks b = g, g + G, … and keep their log-weights in
//           shared memory (at most kHeld a thread, so N ≤ 2^22); after a
//           grid-wide barrier every block merges its trial's partials in
//           pass 2's order and writes lw − lse (or raw lw) from shared
//           memory. The log-weights are written once, in one launch. The
//           launch is cooperative when G > 1, so that every block is
//           resident at the barrier. The barrier waits for the trial's
//           slowest block, and the barrier and the merge, which every block
//           runs, grow with the blocks: G·T is held to half the resident
//           capacity (qt_fused_update_capacity; at 2^20, 512 blocks of two
//           virtual blocks each; every resident block measured slower,
//           chip_profile.py --b1-forms). Tried on an H100 and not kept, as
//           no faster: the merge's loads through L2 only, prefetches of the
//           bank, loads ahead in registers, and the trial's last block
//           merging alone and publishing lse in place of the barrier. With
//           G = 1 a block holds its whole trial and needs no barrier (the
//           256 × 2048 ensemble: one launch, T blocks).
// No atomics: the result is the same from run to run. The second sum reuses
// the first's exponential (Σ e², with the max of 2·lw equal to 2·max lw), as
// the TPU kernel does. The ragged tail is masked by the loop bound instead of
// being padded. `scalars` stays a device pointer (the TPU kernel's SMEM ref),
// so the caller feeds the outcome and t without a host sync.
//
// Trials. An ensemble of T independent banks (the JAX package's custom_vmap
// rule, fused_update.py:197-209, which lax.maps the kernel over the trials
// or falls back to XLA below 2^17 particles) runs on a (block, trial) grid:
// blockIdx.y picks the trial's scalars row, log-weights and columns, each
// trial writes its own partials row, and its merge (pass 2's block, or each
// of its one-launch blocks) reads that row in the same fixed order. Each
// trial's result is therefore bit-equal to a single-bank launch on it, and
// every bank size runs the kernel. A single bank (T = 1) keeps its own instantiation, in
// which nothing is shifted: with the trial offsets, the one-column tiles
// took 0.5–1.1 µs more at 2^20 on an H100 (chip_profile.py --parent).
//
// The likelihood is a device functor: an outcome composition over a pr1
// functor, the tiles of fused_update.py:247-356. TwoOutcome<Pr1> is
// two_outcome_tile (:247), Binomial<Pr1> is binomial_tile (:259, log C(n,k)
// comes in `scalars`, computed on the device by the wrapper). A pr1 functor
// is a struct with
//   static constexpr int kMinCols, kMaxColsUsed;   // columns it takes, ≤ kMaxCols
//   __device__ Pr1(const float* s, const Consts& k, int n_cols);
//   template <class C> __device__ float operator()(const C& c, int64_t i) const;
// The constructor reads the pr1's expparams from `s` (the scalars after the
// outcome composition's head) once per thread and its compile-time
// constants from `k.v` (at most kMaxConsts, passed by value); the call
// returns Pr(outcome 1) of particle i, reading column j as c(j, i).
// Products and sums are rounded one by one (mul, add, sub: no FMA
// contraction), as the plain PyTorch version of the same function computes
// them.
//
// Columns are read in place, by one of two paths chosen at launch:
//  - per column: column j of particle i is p[j][i·stride[j]], any layout.
//    Lanes of a warp are `stride` floats apart, so a warp-wide load of a
//    16-column bank touches 32 lines for 128 useful bytes;
//  - row span (fused_update_span), when the columns are views of one
//    row-major (N, s) bank with 8 ≤ s ≤ 20, or s ≤ 64 for a tile of more
//    than 16 columns (the wrapper's choice: on an H100 the per-column path
//    measured faster for the tiles with s ≤ 5): column j of particle i is
//    base[i·s + off_j].
//    For each grid step a block's 256 rows are one contiguous span of
//    256·s floats. The block stages it in shared memory with coalesced
//    cp.async copies (16 bytes where address and size allow, 4 bytes at
//    an unaligned head and tail, and only up to the last row's largest
//    offset), double-buffered so that step k + 1 is in flight while step k
//    is computed. Each thread then reads its own row from shared memory:
//    as float4s when s % 4 == 0, the span is 16-byte aligned and the
//    columns are 0…n−1 in order (rows 16·s bytes apart then hit all banks
//    through an XOR swizzle of the 16-byte chunks when s % 8 == 0), else
//    one float per column (odd s is conflict-free as it stands).
//    A stage is 256·s floats, two stages up to 41 KB for s ≤ 20. The wide
//    tiles (three-qubit Born, s = 64: 128 KB) take the dynamic shared
//    memory above 48 KB by opting in, and so one block an SM; with 64 KB
//    a stage, the copy in flight while a stage is computed still covers
//    the SM's share of the bandwidth (about 25 KB a µs): 106–112 µs at
//    2^20 on an H100 against the bound's 82.6, a grid of 132 to 2048
//    blocks within 6 µs of each other. Their functor holds its effect and
//    its row in registers (about 64 each; 149 registers, no spill), so
//    their instantiation is bounded for one block an SM, not three.
// Both paths keep the element-to-thread schedule (block b, thread t takes
// rows b·256 + t + k·gridDim.x·256) and the same arithmetic, so they give
// the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 16;  // log-weights a thread of the one-launch form keeps (16 KB a block)
constexpr int kMaxCols = 64;      // the widest functor (Born, three qubits)
constexpr int kNarrowCols = 16;   // the widest functor of three blocks an SM on the row span
constexpr int kMaxConsts = 4;
constexpr float kNegBig = -3.0e38f;
constexpr float kLogTiny = -87.0f;

constexpr int kMaxSpanStride = 64;  // two stages of 256 rows: ≤ 129 KB of shared memory
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in

// A functor reads column j of particle i as c(j, i) through one of three
// accessors. Cols: in place, p[j][i * stride[j]].
struct Cols {
  const float* p[kMaxCols];
  int64_t stride[kMaxCols];
  __device__ __forceinline__ float operator()(int j, int64_t i) const {
    return p[j][i * stride[j]];
  }
};

// Row-span layout: column j of particle i is base[i * stride + off[j]].
struct Span {
  const float* base;
  int stride;
  int max_off;
  int off[kMaxCols];
};

// SmemRow: the thread's staged row in shared memory, one float per column.
struct SmemRow {
  const float* row;
  const int* off;
  __device__ __forceinline__ float operator()(int j, int64_t) const { return row[off[j]]; }
};

// RegRow: the thread's first K floats of its row, loaded as float4s.
template <int K>
struct RegRow {
  float v[K];
  __device__ __forceinline__ float operator()(int j, int64_t) const { return v[j]; }
};

struct Consts {
  float v[kMaxConsts];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp(x, lo, hi): NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float one_minus_cos2(float arg) {
  const float c = cosf(arg);
  return sub(1.0f, mul(c, c));
}

// -- outcome compositions: log L of one particle.

// scalars = [outcome, *pr1]; pr = outcome == 1 ? pr1 : 1 − pr1; log(max(pr, 1e-35)).
template <class Pr1>
struct TwoOutcome {
  using P = Pr1;
  static constexpr int kHead = 1;
  Pr1 pr1;
  bool one;
  __device__ TwoOutcome(const float* s, const Consts& k, int n_cols)
      : pr1(s + kHead, k, n_cols), one(s[0] == 1.0f) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    const float p1 = pr1(c, i);
    const float pr = one ? p1 : sub(1.0f, p1);
    return logf(pr < 1e-35f ? 1e-35f : pr);
  }
};

// scalars = [k, n, log C(n, k), *pr1]; p1 clipped to [0, 1];
// log C + k·log(max(p1, 1e-30)) + (n − k)·log(max(1 − p1, 1e-30)).
template <class Pr1>
struct Binomial {
  using P = Pr1;
  static constexpr int kHead = 3;
  Pr1 pr1;
  float k, n_k, log_c;
  __device__ Binomial(const float* s, const Consts& kc, int n_cols)
      : pr1(s + kHead, kc, n_cols), k(s[0]), n_k(sub(s[1], s[0])), log_c(s[2]) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    const float p1 = clampf(pr1(c, i), 0.0f, 1.0f);
    const float q1 = sub(1.0f, p1);
    const float lp = logf(p1 < 1e-30f ? 1e-30f : p1);
    const float lq = logf(q1 < 1e-30f ? 1e-30f : q1);
    return add(add(log_c, mul(k, lp)), mul(n_k, lq));
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

// kBatched: blockIdx.y is the trial. Trial y reads scalars row y (scalar_stride
// floats apart), log_w and out_lw row y (n apart), each column shifted by
// y·trial_stride elements, and writes its partials row y (gridDim.x partials).
// A single bank (kBatched = false) is the same kernel with nothing shifted:
// it keeps the registers of the single-bank instantiation.
template <class Tile, bool kBatched>
__global__ void __launch_bounds__(kThreads)
fused_update_pass1(const float* __restrict__ scalars, int scalar_stride,
                   Consts consts, int n_cols,
                   const float* __restrict__ log_w, Cols cols, int64_t trial_stride,
                   float* __restrict__ out_lw, float* __restrict__ partials,
                   int64_t n) {
  if constexpr (kBatched) {
    const int64_t y = blockIdx.y;
    scalars += y * scalar_stride;
    log_w += y * n;
    out_lw += y * n;
    partials += y * 3 * static_cast<int64_t>(gridDim.x);
#pragma unroll
    for (int j = 0; j < Tile::P::kMaxColsUsed; ++j) cols.p[j] += y * trial_stride;
  }
  const Tile tile(scalars, consts, n_cols);
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

// -- row-span path ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared position of staged float x (counted from the stage's start): its
// 16-byte chunk XOR-swizzled within aligned groups of eight chunks when
// `swz` is 7, in place when it is 0.
__device__ __forceinline__ int swizzle(int x, int swz) {
  const int c = x >> 2;
  return ((c ^ ((c >> 3) & swz)) << 2) | (x & 3);
}

// Shared floats of one stage: 256 rows of s floats, up to 3 floats of
// head alignment, rounded up to whole swizzle groups (32 floats).
__host__ __device__ constexpr int span_stage_floats(int s) {
  return (kThreads * s + 3 + 31) / 32 * 32;
}

// Stages the rows [r0, min(r0 + 256, n)) of the span, from base + r0·s to
// the last row's largest offset: float x of the range lands at
// swizzle(h + x), h = the range's start modulo 16 bytes, so that 16-byte
// chunks of global memory are 16-byte chunks of shared memory.
__device__ __forceinline__ void stage_span(float* stage, const float* base, int64_t r0,
                                           int64_t n, int s, int max_off, int swz) {
  const int64_t last = (r0 + kThreads < n ? r0 + kThreads : n) - 1;
  const float* p0 = base + r0 * s;
  const int len = static_cast<int>(last - r0) * s + max_off + 1;
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(p0) >> 2) & 3);
  const int head = (4 - h) & 3;                  // floats before the first 16-byte boundary
  const int body = len > head ? (len - head) & ~3 : 0;
  if (body > 0) {
    for (int c = threadIdx.x; c < (body >> 2); c += kThreads) {
      cp_async16(stage + swizzle(h + head + 4 * c, swz), p0 + head + 4 * c);
    }
  }
  // The unaligned head and tail, one float a thread from each end.
  const int tail0 = body > 0 ? head + body : 0;  // no body: every float is "tail"
  if (body > 0 && static_cast<int>(threadIdx.x) < head) {
    cp_async4(stage + swizzle(h + threadIdx.x, swz), p0 + threadIdx.x);
  }
  for (int x = tail0 + kThreads - 1 - static_cast<int>(threadIdx.x); x < len; x += kThreads) {
    cp_async4(stage + swizzle(h + x, swz), p0 + x);
  }
}

// B1 pass 1 over a row-major bank, row spans staged in shared memory (see
// the header). kVec: rows are read as float4s (s % 4 == 0, the span
// 16-byte aligned in every trial, columns 0…n_cols−1 in order). One
// instantiation serves every T: blockIdx.y is the trial (0 for one bank),
// and its offsets are added once, to the pointers.
template <class Tile>
__host__ __device__ constexpr int span_min_blocks() {
  return Tile::P::kMaxColsUsed > kNarrowCols ? 1 : 3;
}

template <class Tile, bool kVec>
__global__ void __launch_bounds__(kThreads, span_min_blocks<Tile>())
fused_update_span(const float* __restrict__ scalars, int scalar_stride, Consts consts,
                  int n_cols, const float* __restrict__ log_w, __grid_constant__ const Span span,
                  int64_t trial_stride, float* __restrict__ out_lw,
                  float* __restrict__ partials, int64_t n) {
  extern __shared__ __align__(16) float stage[];
  const int64_t y = blockIdx.y;
  scalars += y * scalar_stride;
  log_w += y * n;
  out_lw += y * n;
  partials += y * 3 * static_cast<int64_t>(gridDim.x);
  const float* base = span.base + y * trial_stride;
  const int s = span.stride;
  const int stage_floats = span_stage_floats(s);
  const int swz = kVec && s % 8 == 0 ? 7 : 0;
  const Tile tile(scalars, consts, n_cols);
  Lse st{kNegBig, 0.0f, 0.0f};
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t r0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  if (r0 < n) stage_span(stage, base, r0, n, s, span.max_off, swz);
  cp_async_commit();
  for (int k = 0; r0 < n; ++k, r0 += step) {
    if (r0 + step < n) {
      stage_span(stage + ((k + 1) & 1) * stage_floats, base, r0 + step, n, s, span.max_off,
                 swz);
    }
    cp_async_commit();
    const int64_t i = r0 + threadIdx.x;
    const float lwi = i < n ? log_w[i] : 0.0f;
    cp_async_wait<1>();  // every group but the one just committed: step k
    __syncthreads();
    if (i < n) {
      const float* buf = stage + (k & 1) * stage_floats;
      float log_l;
      if constexpr (kVec) {
        constexpr int K = (Tile::P::kMaxColsUsed + 3) / 4 * 4;
        RegRow<K> row;
        const int c0 = threadIdx.x * (s >> 2);
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (4 * q < n_cols) {
            v = *reinterpret_cast<const float4*>(buf + swizzle(4 * (c0 + q), swz));
          }
          row.v[4 * q] = v.x;
          row.v[4 * q + 1] = v.y;
          row.v[4 * q + 2] = v.z;
          row.v[4 * q + 3] = v.w;
        }
        log_l = tile(row, i);
      } else {
        // Unswizzled (swz == 0): the row starts at its head offset h + t·s.
        const int h = static_cast<int>((reinterpret_cast<uintptr_t>(base + r0 * s) >> 2) & 3);
        log_l = tile(SmemRow{buf + h + threadIdx.x * s, span.off}, i);
      }
      const float lw = __fadd_rn(lwi, log_l < kLogTiny ? kLogTiny : log_l);
      out_lw[i] = lw;
      lse_push(st, lw);
    }
    __syncthreads();  // stage k & 1 is refilled at step k + 1
  }
  st = block_reduce(st);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = st.m;
    partials[3 * blockIdx.x + 1] = st.s;
    partials[3 * blockIdx.x + 2] = st.s2;
  }
}

// The merge of a trial's n_blocks partials in the fixed order (strided per
// thread, then block_reduce's tree); thread 0 gets it. Plain loads, cached
// in L1: a thread's (m, s, s2) share lines, which every one-launch block
// would otherwise fetch from L2 three times (__ldcg). In the one-launch
// form other blocks wrote the partials in this launch: the grid barrier's
// acquire orders those writes before these loads, and no block read the
// partials before it.
__device__ Lse merge_partials(const float* partials, int n_blocks) {
  Lse st{kNegBig, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    st = lse_merge(st, Lse{partials[3 * b], partials[3 * b + 1], partials[3 * b + 2]});
  }
  return block_reduce(st);
}

// lse of a merged state; also writes its stats row [lse, lse2, log_norm (=
// lse), ess] unless `stats` is null.
__device__ __forceinline__ float write_stats(Lse st, float* stats) {
  const float lse = st.m + logf(st.s);
  if (stats != nullptr) {
    const float lse2 = 2.0f * st.m + logf(st.s2);
    stats[0] = lse;
    stats[1] = lse2;
    stats[2] = lse;
    stats[3] = expf(-(lse2 - 2.0f * lse));
  }
  return lse;
}

// One block per trial (blockIdx.x).
__global__ void __launch_bounds__(kThreads)
fused_update_pass2(const float* __restrict__ partials, int n_blocks,
                   float* __restrict__ stats) {
  partials += static_cast<int64_t>(blockIdx.x) * 3 * n_blocks;
  stats += 4 * static_cast<int64_t>(blockIdx.x);
  const Lse st = merge_partials(partials, n_blocks);
  if (threadIdx.x == 0) write_stats(st, stats);
}

// The one-launch form (see the header): physical block blockIdx.x of G =
// gridDim.x walks the virtual blocks b = blockIdx.x + v·G < n_blocks of
// trial blockIdx.y (shifted as in pass 1 when kBatched), each thread
// holding its per_thread rows of each in shared memory. `grid_sync`: the
// launch is cooperative and G > 1, so the partials of the other blocks are
// awaited at a grid-wide barrier; else this block holds its whole trial.
// Writes lw − lse (__fsub_rn, as the wrapper's f32 subtraction rounds it)
// when `normalize`, else raw lw, and block 0 of each trial its stats row.
template <class Tile, bool kBatched>
__global__ void __launch_bounds__(kThreads)
fused_update_one(const float* __restrict__ scalars, int scalar_stride, Consts consts,
                 int n_cols, const float* __restrict__ log_w, Cols cols,
                 int64_t trial_stride, float* __restrict__ out_lw, float* partials,
                 float* __restrict__ stats, int n_blocks, int per_thread, int64_t n,
                 int normalize, int grid_sync) {
  __shared__ float held[kHeld * kThreads];
  __shared__ float lse_shared;
  if constexpr (kBatched) {
    const int64_t y = blockIdx.y;
    scalars += y * scalar_stride;
    log_w += y * n;
    out_lw += y * n;
    partials += y * 3 * static_cast<int64_t>(n_blocks);
    stats += 4 * y;
#pragma unroll
    for (int j = 0; j < Tile::P::kMaxColsUsed; ++j) cols.p[j] += y * trial_stride;
  }
  const Tile tile(scalars, consts, n_cols);
  // Rows in 32 bits (this form holds N ≤ 2^22): fewer instructions a
  // particle than pass 1's 64-bit rows, the same rows in the same order.
  const int rows = static_cast<int>(n);
  const int stride = n_blocks * kThreads;
  float* mine = held + threadIdx.x;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    Lse st{kNegBig, 0.0f, 0.0f};
    int i = b * kThreads + static_cast<int>(threadIdx.x);
    for (int k = 0; k < per_thread && i < rows; ++k, i += stride) {
      const float log_l = tile(cols, i);
      const float lw = __fadd_rn(log_w[i], log_l < kLogTiny ? kLogTiny : log_l);
      mine[k * kThreads] = lw;
      lse_push(st, lw);
    }
    mine += per_thread * kThreads;
    st = block_reduce(st);
    if (threadIdx.x == 0) {
      partials[3 * b + 0] = st.m;
      partials[3 * b + 1] = st.s;
      partials[3 * b + 2] = st.s2;
    }
    __syncthreads();  // block_reduce's shared totals are rewritten next
  }
  if (grid_sync) {
    cooperative_groups::this_grid().sync();  // also orders the partials' writes
  } else {
    __syncthreads();
  }
  const Lse st = merge_partials(partials, n_blocks);
  if (threadIdx.x == 0) lse_shared = write_stats(st, blockIdx.x == 0 ? stats : nullptr);
  __syncthreads();
  const float lse = lse_shared;
  mine = held + threadIdx.x;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    int i = b * kThreads + static_cast<int>(threadIdx.x);
    for (int k = 0; k < per_thread && i < rows; ++k, i += stride) {
      out_lw[i] = normalize ? __fsub_rn(mine[k * kThreads], lse) : mine[k * kThreads];
    }
    mine += per_thread * kThreads;
  }
}

// What one launch needs besides the functor: the device pointers and the
// (n_blocks, n_trials) grid. span.stride > 0 takes the row-span path;
// grid_blocks > 0 the one-launch form with that many blocks a trial (else
// the two-pass form). capacity != nullptr asks for the one-launch form's
// resident capacity instead of launching.
struct Launch {
  const float* scalars;
  int scalar_stride;
  Consts consts;
  int n_cols;
  const float* log_w;
  Cols cols;
  Span span;
  int64_t trial_stride;
  float* out;
  float* partials;
  float* stats;
  int n_blocks;
  int n_trials;
  int64_t n;
  int grid_blocks;
  int normalize;
  int* capacity;
  cudaStream_t stream;
};

// Rows as float4s: s % 4 == 0, every trial's span 16-byte aligned, and the
// columns 0…n_cols−1 in order.
static bool span_vec(const Launch& a) {
  if (a.span.stride % 4 != 0 || reinterpret_cast<uintptr_t>(a.span.base) % 16 != 0 ||
      (a.n_trials > 1 && a.trial_stride % 4 != 0)) {
    return false;
  }
  for (int j = 0; j < a.n_cols; ++j) {
    if (a.span.off[j] != j) return false;
  }
  return true;
}

// Two stages over 48 KB (s > 23) opt in to the larger dynamic shared
// memory first, on the current device.
template <class Tile, bool kVec>
static int launch_span(const Launch& a) {
  const dim3 grid(a.n_blocks, a.n_trials);
  const size_t smem = 2 * sizeof(float) * span_stage_floats(a.span.stride);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(fused_update_span<Tile, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_update_span<Tile, kVec><<<grid, kThreads, smem, a.stream>>>(
      a.scalars, a.scalar_stride, a.consts, a.n_cols, a.log_w, a.span, a.trial_stride,
      a.out, a.partials, a.n);
  return 0;
}

// Blocks of fused_update_one<Tile, kBatched> resident on the current device
// at once: the most a cooperative launch of it may hold.
template <class Tile, bool kBatched>
static int one_capacity(int* capacity) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_update_one<Tile, kBatched>,
                                                      kThreads, 0);
  }
  if (e == cudaSuccess) *capacity = per_sm * sms;
  return static_cast<int>(e);
}

// The one-launch form on a (grid_blocks, n_trials) grid, cooperative when
// grid_blocks > 1 (the launch fails, cudaErrorCooperativeLaunchTooLarge,
// when the grid exceeds the resident capacity).
template <class Tile, bool kBatched>
static int launch_one(const Launch& a) {
  const int64_t span = static_cast<int64_t>(a.n_blocks) * kThreads;
  const int64_t per_thread = (a.n + span - 1) / span;
  const int64_t per_block = (a.n_blocks + a.grid_blocks - 1) / a.grid_blocks;
  // The kernel's rows are 32-bit: n ≤ n_blocks·256·kHeld < 2^31.
  if (a.grid_blocks > a.n_blocks || per_thread * per_block > kHeld ||
      a.n_blocks > INT32_MAX / (kThreads * kHeld)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute coop{};
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(a.grid_blocks, a.n_trials);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.stream;
  cfg.attrs = &coop;
  cfg.numAttrs = a.grid_blocks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_update_one<Tile, kBatched>, a.scalars, a.scalar_stride, a.consts, a.n_cols,
      a.log_w, a.cols, a.trial_stride, a.out, a.partials, a.stats, a.n_blocks,
      static_cast<int>(per_thread), a.n, a.normalize, a.grid_blocks > 1 ? 1 : 0);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <class Tile>
static int launch(const Launch& a) {
  if (a.n_cols < Tile::P::kMinCols || a.n_cols > Tile::P::kMaxColsUsed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.capacity != nullptr) {
    return a.n_trials == 1 ? one_capacity<Tile, false>(a.capacity)
                           : one_capacity<Tile, true>(a.capacity);
  }
  if (a.span.stride > 0) {
    // Only multi-column functors read a bank by rows; the row span has the
    // two-pass form only.
    if constexpr (Tile::P::kMaxColsUsed >= 2) {
      if (a.grid_blocks > 0) return static_cast<int>(cudaErrorInvalidValue);
      const int err = span_vec(a) ? launch_span<Tile, true>(a) : launch_span<Tile, false>(a);
      if (err != 0) return err;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (a.grid_blocks > 0) {
    return a.n_trials == 1 ? launch_one<Tile, false>(a) : launch_one<Tile, true>(a);
  } else if (a.n_trials == 1) {
    fused_update_pass1<Tile, false><<<a.n_blocks, kThreads, 0, a.stream>>>(
        a.scalars, a.scalar_stride, a.consts, a.n_cols, a.log_w, a.cols,
        a.trial_stride, a.out, a.partials, a.n);
  } else {
    const dim3 grid(a.n_blocks, a.n_trials);
    fused_update_pass1<Tile, true><<<grid, kThreads, 0, a.stream>>>(
        a.scalars, a.scalar_stride, a.consts, a.n_cols, a.log_w, a.cols,
        a.trial_stride, a.out, a.partials, a.n);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- the C entry points --------------------------------------------------------
//
// Dispatch is a struct with `static int run(int outcome, int pr1, const
// Launch& a)`, which launches (or, with a.capacity set, asks the capacity
// of) the instantiation of the tile (outcome, pr1).
//
// outcome: 0 = TwoOutcome, 1 = Binomial. pr1: the functor id in the
// library (the built-in one's switch, or 0 for a user functor). consts: host
// array of n_consts floats. cols, col_strides: host arrays of n_cols device
// pointers and their element strides. span_stride > 0 takes the row-span
// path instead: column j of particle i is span_base[i·span_stride +
// span_offsets[j]] (span_offsets: host array of n_cols ints in [0,
// span_stride), span_stride ≤ kMaxSpanStride; cols and col_strides are
// then not read). n_trials banks of n particles: scalars (n_trials,
// scalar_stride), log_w and out_lw (n_trials, n), column j of trial y
// starts trial_stride elements after trial y − 1's; partials:
// 3·n_blocks·n_trials floats; stats: 4·n_trials floats. One bank is
// n_trials = 1 (the strides are then not read). grid_blocks: 0 takes the
// two-pass form (out_lw raw), G > 0 the one-launch form with G blocks a
// trial (per-column path only; out_lw is lw − lse when normalize, else
// raw). Returns the cudaError_t of the launches (0 on success).
template <class Dispatch>
static int fused_update_entry(int outcome, int pr1, const void* scalars, int scalar_stride,
                              const void* consts, int n_consts, const void* log_w,
                              const void* const* cols, const int64_t* col_strides, int n_cols,
                              const void* span_base, const int32_t* span_offsets,
                              int span_stride, int64_t trial_stride, void* out_lw,
                              void* partials, int n_blocks, void* stats, int64_t n,
                              int n_trials, int grid_blocks, int normalize, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || n_consts < 0 || n_consts > kMaxConsts ||
      n_blocks <= 0 || n <= 0 || n_trials <= 0 || n_trials > 65535 ||
      scalar_stride < 0 || trial_stride < 0 || span_stride < 0 ||
      span_stride > kMaxSpanStride || grid_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{};
  if (span_stride > 0) {
    a.span.base = static_cast<const float*>(span_base);
    a.span.stride = span_stride;
    for (int j = 0; j < n_cols; ++j) {
      const int off = span_offsets[j];
      if (off < 0 || off >= span_stride) return static_cast<int>(cudaErrorInvalidValue);
      a.span.off[j] = off;
      a.span.max_off = off > a.span.max_off ? off : a.span.max_off;
    }
  } else {
    for (int j = 0; j < n_cols; ++j) {
      if (col_strides[j] < 0) return static_cast<int>(cudaErrorInvalidValue);
      a.cols.p[j] = static_cast<const float*>(cols[j]);
      a.cols.stride[j] = col_strides[j];
    }
  }
  for (int j = 0; j < n_consts; ++j) a.consts.v[j] = static_cast<const float*>(consts)[j];
  a.scalars = static_cast<const float*>(scalars);
  a.scalar_stride = scalar_stride;
  a.n_cols = n_cols;
  a.log_w = static_cast<const float*>(log_w);
  a.trial_stride = trial_stride;
  a.out = static_cast<float*>(out_lw);
  a.partials = static_cast<float*>(partials);
  a.stats = static_cast<float*>(stats);
  a.n_blocks = n_blocks;
  a.n_trials = n_trials;
  a.n = n;
  a.grid_blocks = grid_blocks;
  a.normalize = normalize != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  const int err = Dispatch::run(outcome, pr1, a);
  if (err != 0 || grid_blocks > 0) return err;
  fused_update_pass2<<<n_trials, kThreads, 0, a.stream>>>(
      a.partials, n_blocks, a.stats);
  return static_cast<int>(cudaGetLastError());
}

// The one-launch form's resident capacity on the current device, in
// blocks, for the instantiation that qt_fused_update takes with these
// (outcome, pr1, n_cols) and this many trials (1: the single-bank one),
// written to *capacity. Returns the cudaError_t (0 on success).
template <class Dispatch>
static int fused_update_capacity_entry(int outcome, int pr1, int n_cols, int n_trials,
                                       int* capacity) {
  if (n_cols < 0 || n_cols > kMaxCols || n_trials <= 0 || capacity == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{};
  a.n_cols = n_cols;
  a.n_trials = n_trials;
  a.capacity = capacity;
  return Dispatch::run(outcome, pr1, a);
}

// The extern "C" pair of a library whose tiles Dispatch launches:
// qt_fused_update and qt_fused_update_capacity, with the arguments above.
#define QT_FUSED_UPDATE_ENTRIES(Dispatch)                                                   \
  extern "C" int qt_fused_update(                                                           \
      int outcome, int pr1, const void* scalars, int scalar_stride, const void* consts,     \
      int n_consts, const void* log_w, const void* const* cols, const int64_t* col_strides, \
      int n_cols, const void* span_base, const int32_t* span_offsets, int span_stride,      \
      int64_t trial_stride, void* out_lw, void* partials, int n_blocks, void* stats,        \
      int64_t n, int n_trials, int grid_blocks, int normalize, void* stream) {              \
    return fused_update_entry<Dispatch>(                                                    \
        outcome, pr1, scalars, scalar_stride, consts, n_consts, log_w, cols, col_strides,   \
        n_cols, span_base, span_offsets, span_stride, trial_stride, out_lw, partials,       \
        n_blocks, stats, n, n_trials, grid_blocks, normalize, stream);                      \
  }                                                                                         \
  extern "C" int qt_fused_update_capacity(int outcome, int pr1, int n_cols, int n_trials,   \
                                          int* capacity) {                                  \
    return fused_update_capacity_entry<Dispatch>(outcome, pr1, n_cols, n_trials, capacity); \
  }

// One pr1 functor under both outcome compositions, as functor id 0.
template <class Pr1>
struct OneFunctor {
  static int run(int outcome, int pr1, const Launch& a) {
    if (pr1 != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (outcome) {
      case 0: return launch<TwoOutcome<Pr1>>(a);
      case 1: return launch<Binomial<Pr1>>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace

// The library of one functor: every form (single bank and trial grid, one
// launch and two passes, the row span) of TwoOutcome<Pr1> and Binomial<Pr1>.
#define QT_FUSED_UPDATE_FUNCTOR(Pr1) QT_FUSED_UPDATE_ENTRIES(OneFunctor<Pr1>)
