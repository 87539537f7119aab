// Systematic-resampling expand (B2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel qinfer_tpu/ops/resample_expand.py:115
// (_expand_kernel, launched at :361 by _expand_cols). It computes
//     out[i, d] = values[j(i), d] · scale_d + shift_d,   j(i) = max{j : starts[j] ≤ i}
// for sorted int32 starts with starts[0] == 0; the affine is the fused
// Liu–West shrinkage a·x + (1 − a)·μ, and is skipped when `affine` is NULL.
// n_out may be less than n_in (the caller shifts the starts to its window).
//
// What bounds it on this card: memory, where the search does not. Per
// output row it reads one start and D values and writes D values, 4·(D+1)
// + 4·D bytes, about 12 MB for 2^20 rows at D = 1 (about 4 µs at 3.35
// TB/s). A binary search for each row reads ~20 starts, dependent loads
// from the 50 MB L2 cache whose latency and not their bytes set the time.
//
// Design: four forms (`form`, chosen by the caller from D, the trial count
// and the bank's size, ops/resample_expand.py:kernel_form):
//  - rows (form 0): one thread per output row binary-searches
//    upper_bound(starts, i) − 1 and reads and writes its D values. At
//    D = 1 neighbouring lanes write neighbouring floats; the time is the
//    search's ~20 dependent probes, mostly cache hits, so latency and not
//    bytes bounded it up to D = 8 (≈ 25 µs at 2^20 on an H100). It stays
//    for single banks too large for the bank form's block and too small
//    for the merge path;
//  - merge path (form 2, D ≤ 8): the starts and the row indices 0…n_out−1
//    are merged (a start equal to i before row i), and block x takes the
//    merged items [x·2048, (x + 1)·2048): its starts [a0, a1) and rows
//    [b0, b1). Start k sits at min(starts[k], n_out) + k in the merge,
//    strictly increasing, so each end is one search (a warp's 32-ary
//    rounds, two warps for the two ends): one search a block instead of
//    one a row. The block's window of at most 2048 starts is then in
//    shared memory, whatever the weights (thousands of equal starts
//    included), loaded coalesced. Row i of the block has j(i) = a0 − 1 +
//    #{k ∈ [a0, a1) : starts[k] ≤ i}: each start that ends a run of equal
//    starts marks its row in shared memory, and a block-wide max-scan
//    fills the rows between, a fixed cost a row for any weights (halving
//    the window for each row cost a dozen instructions a probe, and most
//    of a block's time). The block then writes its rows (copy_rows),
//    (b1 − b0)·D contiguous floats, in element order, as float4s or float2s
//    where D and the alignment allow: coalesced at every D. Its per-block
//    searches are amortised only on large launches;
//  - bank (form 3, D ≤ 8, n_in ≤ 2^15): for launches of fewer items, the
//    masked trials of an ensemble's resample (74 of 256 banks of 2048 at
//    the median) and the small banks of the examples (2000–10000
//    particles). Block (x, y) writes a tile of ≤ 2048 rows of trial y. It
//    stages the bank's starts below its rows' end in shared memory with
//    16-byte cp.async copies, all of a phase in flight at once, and finds
//    every row's source there, searching nothing in global memory. On many
//    banks a block takes a whole bank of 2048 rows and scans: each staged
//    start in its rows that ends its run marks its row, the last start
//    below its rows is found in the same pass (the one whose successor is
//    not below them), a thread owns four consecutive rows and a warp scan
//    of the threads' maxima fills the rows between. On a few banks, small
//    tiles (256 rows) spread a bank over as many SMs, and each thread
//    binary-searches its row in the staged starts (about 13 probes in
//    shared memory at 5000). Either way a row costs the same for any
//    weights, and copy_rows writes the tile. Its latency is one staged
//    load, the search or scan, and the copy, against the rows form's ~11
//    dependent probes a row in global memory at 2048;
//  - the bank form with the Liu–West prologue (expand_bank_liu_west,
//    qt_liu_west_expand; D ≤ 8, banks of ≤ 2048 rows): what
//    LiuWestResampler.batched built with about fifty small eager launches
//    (the log-sum-exp, μ and Σ, Σ^{1/2} at D = 1, the integer CDF and the
//    systematic starts) a block computes itself from the bank's
//    log-weights, rows and stratum offset, then expands as the scanned bank
//    form does. A bank of 2048 rows at D = 1 is 24 KB, so the block reads
//    it once into registers and keeps the starts in shared memory; the
//    launch is one block a bank, and its cost a few block reductions and
//    barriers against the chain's launches and host time;
//  - span (form 1, D > 8): a warp writes its 32 consecutive rows, one
//    contiguous span of 32·D floats. The warp finds the bounds of its rows'
//    sources together (32 probes a round, four rounds for 2^20 starts) and
//    each lane its own source among the ≤ 32 starts between them by
//    shuffles; then neighbouring lanes copy neighbouring 16 bytes of the
//    span as float4s (D % 4 == 0 and aligned arrays), else neighbouring
//    floats, each taking its row's source by shuffle. At D = 16 the rows
//    form's lanes were 64 bytes apart, so every store instruction wrote 32
//    partial sectors (171 µs at 2^20 on an H100, against 64 µs).
// Measured on an H100 (chip_profile.py --b2-forms, PERF.md §6): the rows
// form was faster than the span form up to D = 8, the span form from
// D = 12; a block-wide search (256 probes a round, a window keyed to the
// block's rows, unbounded under degenerate weights) and the per-lane
// search in the span form were both slower at D = 16.
// None of the TPU kernel's machinery carries over: the DMA ring, the bf16
// plane splits, the MXU one-hot selects and the shifted value streams all
// work around Mosaic (see that module's docstring). The affine is rounded
// as a product and then a sum (no FMA contraction), exactly as the plain
// PyTorch version computes it, so the two agree bit for bit in every form.
//
// Trials. T independent banks (the JAX package's sequential_vmap,
// resample_expand.py:359, which runs the kernel once per trial) are one
// launch on a (row block, merge tile or bank tile, trial) grid: blockIdx.y picks the
// trial's starts, values, affine (μ differs per trial) and output rows. A
// single bank is T = 1, where blockIdx.y is 0 and nothing moves. gridDim.y bounds T at
// 65535.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// j(i) = max{j : starts[j] ≤ i} (0 if none): the first k with starts[k] >
// i, less one, by halving a (first, count) range. The probe is a pointer
// step, so the trial's offset is added once and not in every probe's
// address.
__device__ __forceinline__ int64_t source_row(const int32_t* starts, int64_t n_in,
                                              int64_t i) {
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
  return lo > 0 ? lo - 1 : 0;
}

__device__ __forceinline__ float affine_at(float v, const float* affine, int n_cols, int d) {
  return __fadd_rn(__fmul_rn(v, __ldg(affine + d)), __ldg(affine + n_cols + d));
}

// Form 0: one thread per output row.
__global__ void __launch_bounds__(kThreads)
expand_rows(const int32_t* __restrict__ starts, int64_t n_in,
            const float* __restrict__ values, int n_cols,
            const float* __restrict__ affine, float* __restrict__ out, int64_t n_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t y = blockIdx.y;
  starts += y * n_in;
  values += y * n_in * n_cols;
  out += y * n_out * n_cols;
  if (affine != nullptr) affine += y * 2 * n_cols;
  const float* src = values + source_row(starts, n_in, i) * n_cols;
  float* dst = out + i * n_cols;
  for (int d = 0; d < n_cols; ++d) {
    const float v = __ldg(src + d);
    dst[d] = affine != nullptr ? affine_at(v, affine, n_cols, d) : v;
  }
}

// ub(x0) and ub(x1), ub(x) = the first k < n_in with starts[k] > x (n_in
// if none), found by the 32 lanes of a warp together: each round a lane
// probes one start of each range and a ballot counts the probes at or
// below x, so each range shrinks 32-fold (four rounds for 2^20 starts,
// against ~20 dependent probes of one lane's binary search).
__device__ __forceinline__ void warp_upper_bounds(const int32_t* starts, int64_t n_in,
                                                  int64_t x0, int64_t x1, int lane,
                                                  int64_t& ub0, int64_t& ub1) {
  int64_t a0 = 0, b0 = n_in, a1 = 0, b1 = n_in;  // ub ∈ [a, b]
  while (a0 < b0 || a1 < b1) {  // warp-uniform
    const int64_t s0 = (b0 - a0 + 31) >> 5;
    const int64_t s1 = (b1 - a1 + 31) >> 5;
    const int64_t p0 = a0 + lane * s0;
    const int64_t p1 = a1 + lane * s1;
    const bool le0 = p0 < b0 && static_cast<int64_t>(__ldg(starts + p0)) <= x0;
    const bool le1 = p1 < b1 && static_cast<int64_t>(__ldg(starts + p1)) <= x1;
    const int c0 = __popc(__ballot_sync(0xffffffffu, le0));
    const int c1 = __popc(__ballot_sync(0xffffffffu, le1));
    // c probes at or below x: ub lies after probe c − 1 and at or before probe c.
    if (c0 > 0) {
      b0 = a0 + c0 * s0 < b0 ? a0 + c0 * s0 : b0;
      a0 += (c0 - 1) * s0 + 1;
    } else {
      b0 = a0;
    }
    if (c1 > 0) {
      b1 = a1 + c1 * s1 < b1 ? a1 + c1 * s1 : b1;
      a1 += (c1 - 1) * s1 + 1;
    } else {
      b1 = a1;
    }
  }
  ub0 = a0;
  ub1 = a1;
}

// j(r0 + lane) for the warp's rows [r0, r0 + rows): every row's ub lies in
// [ub(r0), ub(r0 + rows − 1)]. When that window holds at most 32 starts,
// lane k keeps the k-th in a register and each lane counts the starts at or
// below its row with six shuffles; else each lane binary-searches the
// window in global memory.
__device__ __forceinline__ int warp_source_rows(const int32_t* starts, int64_t n_in,
                                                int64_t r0, int rows, int lane) {
  int64_t lo, hi;
  warp_upper_bounds(starts, n_in, r0, r0 + rows - 1, lane, lo, hi);
  const int64_t i = r0 + lane;
  if (hi - lo <= 32) {  // warp-uniform
    const int32_t w = lane < hi - lo ? __ldg(starts + lo + lane) : INT32_MAX;
    int pos = 0;  // the largest pos ≤ 31 with window[pos − 1] ≤ i
#pragma unroll
    for (int bit = 16; bit > 0; bit >>= 1) {
      if (static_cast<int64_t>(__shfl_sync(0xffffffffu, w, pos + bit - 1)) <= i) pos += bit;
    }
    pos += static_cast<int64_t>(__shfl_sync(0xffffffffu, w, pos)) <= i ? 1 : 0;
    const int64_t ub = lo + pos;
    return static_cast<int>(ub > 0 ? ub - 1 : 0);
  }
  // starts[lo − 1] ≤ r0 ≤ i, so j(i) lies in [lo − 1, hi − 1].
  return static_cast<int>(lo > 0 ? lo - 1 + source_row(starts + lo - 1, hi - lo + 1, i)
                                 : source_row(starts, hi, i));
}

// Form 1: each warp writes the span of its 32 rows, 32·D contiguous
// floats. The warp finds its rows' sources together (warp_source_rows);
// the copy then walks the span in lane order, each lane taking its
// element's source row from the lane that holds it (a shuffle), so the
// warp needs no shared memory and no block barrier. kVec: float4 copies (n_cols % 4 == 0, every array 16-byte
// aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
expand_span(const int32_t* __restrict__ starts, int64_t n_in,
            const float* __restrict__ values, int n_cols,
            const float* __restrict__ affine, float* __restrict__ out, int64_t n_out) {
  const int64_t y = blockIdx.y;
  starts += y * n_in;
  values += y * n_in * n_cols;
  out += y * n_out * n_cols;
  if (affine != nullptr) affine += y * 2 * n_cols;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  if (r0 >= n_out) return;  // the whole warp
  const int rows = static_cast<int>(n_out - r0 < 32 ? n_out - r0 : 32);
  const int j = warp_source_rows(starts, n_in, r0, rows, lane);
  float* dst = out + r0 * n_cols;
  const int per_row = kVec ? n_cols >> 2 : n_cols;  // elements (float4 or float) a row
  const int n_elems = rows * per_row;
  for (int e0 = 0; e0 < n_elems; e0 += 32) {
    const int e = e0 + lane;
    const int r = e / per_row;  // < rows for every e < n_elems
    const int64_t jr = __shfl_sync(0xffffffffu, j, r < 32 ? r : 31);  // widened after the shuffle
    if (e < n_elems) {
      const int c = e - r * per_row;
      if constexpr (kVec) {
        float4 v = __ldg(reinterpret_cast<const float4*>(values + jr * n_cols) + c);
        if (affine != nullptr) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(affine) + c);
          const float4 b = __ldg(reinterpret_cast<const float4*>(affine + n_cols) + c);
          v.x = __fadd_rn(__fmul_rn(v.x, a.x), b.x);
          v.y = __fadd_rn(__fmul_rn(v.y, a.y), b.y);
          v.z = __fadd_rn(__fmul_rn(v.z, a.z), b.z);
          v.w = __fadd_rn(__fmul_rn(v.w, a.w), b.w);
        }
        reinterpret_cast<float4*>(dst)[e] = v;
      } else {
        const float v = __ldg(values + jr * n_cols + c);
        dst[e] = affine != nullptr ? affine_at(v, affine, n_cols, c) : v;
      }
    }
  }
}

constexpr int kMergeTile = 2048;  // merged items (starts and rows) a block

// The number of starts among the first d items of the merge: the first k
// with min(starts[k], n_out) + k ≥ d, found by the 32 lanes of a warp in
// 32-ary rounds (as warp_upper_bounds); it lies in [max(0, d − n_out),
// min(d, n_in)].
__device__ __forceinline__ int64_t merge_split(const int32_t* starts, int64_t n_in,
                                               int64_t n_out, int64_t d, int lane) {
  int64_t a = d > n_out ? d - n_out : 0;
  int64_t b = d < n_in ? d : n_in;
  while (a < b) {  // warp-uniform
    const int64_t s = (b - a + 31) >> 5;
    const int64_t p = a + lane * s;
    bool below = false;
    if (p < b) {
      const int64_t v = __ldg(starts + p);
      below = (v < n_out ? v : n_out) + p < d;
    }
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c > 0) {
      b = a + c * s < b ? a + c * s : b;
      a += (c - 1) * s + 1;
    } else {
      b = a;
    }
  }
  return a;
}

// Width of the merge path's copies: a row's kD floats as float4s or
// float2s where kD allows and the arrays are aligned (kVec), else floats.
template <int kD, bool kVec>
__host__ __device__ constexpr int merge_width() {
  return !kVec ? 1 : kD % 4 == 0 ? 4 : kD % 2 == 0 ? 2 : 1;
}

template <int kW> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// The affine of copy_rows, column d of a row: the trial's (2, kD) [scale;
// shift] rows in global memory, or none (NULL).
template <int kD>
struct GlobalAffine {
  const float* rows;
  __device__ __forceinline__ float operator()(float v, int d) const {
    return rows != nullptr ? affine_at(v, rows, kD, d) : v;
  }
};

// The Liu–West shrinkage a·v + shift_d with the shifts in shared memory,
// rounded as affine_at rounds it.
struct Shrink {
  float a;
  const float* shift;
  __device__ __forceinline__ float operator()(float v, int d) const {
    return __fadd_rn(__fmul_rn(v, a), shift[d]);
  }
};

// The affine of columns c…c + kW − 1 of a row.
template <class F>
__device__ __forceinline__ float affine_lanes(float v, const F& f, int c) {
  return f(v, c);
}
template <class F>
__device__ __forceinline__ float2 affine_lanes(float2 v, const F& f, int c) {
  return make_float2(f(v.x, c), f(v.y, c + 1));
}
template <class F>
__device__ __forceinline__ float4 affine_lanes(float4 v, const F& f, int c) {
  return make_float4(f(v.x, c), f(v.y, c + 1), f(v.z, c + 2), f(v.w, c + 3));
}

// Writes a block's `rows` consecutive output rows from their sources in
// shared memory: rows·kD contiguous floats in element order, kW =
// merge_width<kD, kVec>() at a time, neighbouring threads on neighbouring
// elements, each through `affine` (GlobalAffine or Shrink). `values` is
// the trial's, `dst_rows` its first row; the block has kBlock threads.
template <int kBlock, int kD, bool kVec, class F>
__device__ __forceinline__ void copy_rows(const int32_t* source, int rows,
                                          const float* __restrict__ values, const F& affine,
                                          float* __restrict__ dst_rows) {
  constexpr int kW = merge_width<kD, kVec>();
  constexpr int kPerRow = kD / kW;
  using T = typename Vec<kW>::T;
  const T* src = reinterpret_cast<const T*>(values);
  T* dst = reinterpret_cast<T*>(dst_rows);
  for (int e = threadIdx.x; e < rows * kPerRow; e += kBlock) {
    const int r = e / kPerRow;
    const int c = e - r * kPerRow;
    const T v = __ldg(src + static_cast<int64_t>(source[r]) * kPerRow + c);
    dst[e] = affine_lanes(v, affine, c * kW);
  }
}

// Form 2: block x merges the items [x·kMergeTile, (x + 1)·kMergeTile)
// (see the header) at kD columns, copied kW = merge_width<kD, kVec>() at a
// time.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads)
expand_merge(const int32_t* __restrict__ starts, int64_t n_in,
             const float* __restrict__ values, const float* __restrict__ affine,
             float* __restrict__ out, int64_t n_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int32_t window[kMergeTile];
  __shared__ int32_t source[kMergeTile];
  __shared__ int64_t split[2];
  __shared__ int32_t warp_max[kWarps];
  const int64_t y = blockIdx.y;
  starts += y * n_in;
  values += y * n_in * kD;
  out += y * n_out * kD;
  if (affine != nullptr) affine += y * 2 * kD;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kMergeTile;
  const int64_t d1 = d0 + kMergeTile < n_in + n_out ? d0 + kMergeTile : n_in + n_out;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int64_t a = merge_split(starts, n_in, n_out, warp ? d1 : d0, lane);
    if (lane == 0) split[warp] = a;
  }
  __syncthreads();
  const int64_t a0 = split[0];
  const int64_t b0 = d0 - a0;
  const int w = static_cast<int>(split[1] - a0);
  const int rows = static_cast<int>(d1 - split[1] - b0);
  // j(b0 + r) = a0 − 1 + #{window starts ≤ b0 + r}, clamped at 0: the last
  // window start at or below row b0 + r, else a0 − 1.
  const int32_t before = a0 > 0 ? static_cast<int32_t>(a0 - 1) : 0;
  if (w == 0) {  // rows only (the rows between heavy particles' starts)
    for (int r = threadIdx.x; r < rows; r += kThreads) source[r] = before;
  } else {
    for (int x = threadIdx.x; x < w; x += kThreads) window[x] = __ldg(starts + a0 + x);
    for (int r = threadIdx.x; r < rows; r += kThreads) source[r] = -1;
    __syncthreads();
    // Each window start that ends its run of equal starts marks its row (a
    // run that the tile's end cuts lies at or beyond row b1: no mark).
    for (int x = threadIdx.x; x < w; x += kThreads) {
      const int64_t r = window[x] - b0;
      if (r < rows && (x + 1 == w || window[x + 1] != window[x])) {
        source[r] = static_cast<int32_t>(a0 + x);
      }
    }
    __syncthreads();
    // Fill each row with the last mark at or before it: a max-scan (marks
    // grow with the row), warp k over rows [k·chunk, (k + 1)·chunk), 32 at
    // a time, then each row against the maxima of the warps before.
    const int chunk = (rows + kWarps - 1) / kWarps;
    const int r0 = warp * chunk;
    const int r1 = r0 + chunk < rows ? r0 + chunk : rows;
    int32_t carry = -1;
    for (int base = r0; base < r1; base += 32) {  // warp-uniform
      const int r = base + lane;
      int32_t v = r < r1 ? source[r] : -1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off && o > v) v = o;
      }
      if (carry > v) v = carry;
      if (r < r1) source[r] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) warp_max[warp] = carry;
    __syncthreads();
    int32_t least = before;
    for (int k = 0; k < warp; ++k) least = warp_max[k] > least ? warp_max[k] : least;
    for (int r = r0 + lane; r < r1; r += 32) {
      if (source[r] < least) source[r] = least;
    }
  }
  __syncthreads();
  copy_rows<kThreads, kD, kVec>(source, rows, values, GlobalAffine<kD>{affine},
                                out + b0 * kD);
}

template <int kD, bool kVec>
static void launch_merge(const int32_t* s, int64_t n_in, const float* v, const float* a,
                         float* o, int64_t n_out, int n_trials, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n_in + n_out + kMergeTile - 1) / kMergeTile),
                  static_cast<unsigned>(n_trials));
  expand_merge<kD, kVec><<<grid, kThreads, 0, st>>>(s, n_in, v, a, o, n_out);
}

template <int kD>
static void launch_merge(const int32_t* s, int64_t n_in, const float* v, const float* a,
                         float* o, int64_t n_out, int n_trials, cudaStream_t st) {
  constexpr int kW = merge_width<kD, true>();
  const uintptr_t bits = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (kW > 1 && bits % (4 * kW) == 0) {
    launch_merge<kD, true>(s, n_in, v, a, o, n_out, n_trials, st);
  } else {
    launch_merge<kD, false>(s, n_in, v, a, o, n_out, n_trials, st);
  }
}

constexpr int kBankCap = 1 << 15;     // starts a bank-form block stages (128 KB)
constexpr int kBankThreads = 512;     // threads a bank-form block has
constexpr int kBankRowsPerThread = 4; // consecutive rows a thread owns on a scanned tile
constexpr int kBankMaxRows = kBankThreads * kBankRowsPerThread;  // rows a tile
constexpr int kStagePhase = 1 << 14;  // starts a staging phase copies

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Stages the bank's starts [0, m) into `window` and returns m: the starts
// the tile's rows [·, r1) can need, those below ub(r1 − 1), rounded up to
// a phase. Each phase copies kStagePhase starts, 16 bytes a copy
// (cp.async, all in flight at once; the head and tail that are not
// 16-byte aligned with single loads, in the first phase); a phase whose
// last start lies at or past r1 ends the staging, since every later one
// does too. `window` is offset so that window + k and starts + k share
// their alignment mod 16. Ends with the block synchronised.
__device__ __forceinline__ int stage_starts(const int32_t* __restrict__ starts, int n_in,
                                            int64_t r1, int32_t* window) {
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(starts) & 15)) & 15) >> 2;
  head = head < n_in ? head : n_in;
  const int n4 = (n_in - head) >> 2;  // whole 16-byte groups after the head
  const int tail = head + 4 * n4;     // [tail, n_in): the unaligned end
  const int t = threadIdx.x;
  if (t < head) window[t] = __ldg(starts + t);
  if (t < n_in - tail) window[tail + t] = __ldg(starts + tail + t);
  for (int q0 = 0;; q0 += kStagePhase / 4) {  // block-uniform
    const int q1 = q0 + kStagePhase / 4 < n4 ? q0 + kStagePhase / 4 : n4;
    for (int q = q0 + t; q < q1; q += kBankThreads) {
      cp_async16(window + head + 4 * q, starts + head + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (q1 == n4) return n_in;
    const int m = head + 4 * q1;  // staged: [0, m) and the tail
    if (window[m - 1] >= r1) return m;
  }
}

// The scanned tile's fill: thread t owns rows [4t, 4t + 4) of `source`
// (each −1 or the mark of a run that ends there; rows ≥ `rows` are not
// touched) and gives each row the last mark at or before it, at least
// `least`: its own rows scanned, a warp scan of the threads' maxima, then
// the maxima of the warps before (`warp_max`, a slot a warp). Called after
// a barrier; ends without one.
__device__ __forceinline__ void fill_marks(int32_t* source, int rows, int32_t least,
                                           int32_t* warp_max) {
  const int base = threadIdx.x * kBankRowsPerThread;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* own = reinterpret_cast<int4*>(source) + threadIdx.x;
  int4 q = base < rows ? *own : make_int4(-1, -1, -1, -1);
  q.y = q.x > q.y ? q.x : q.y;
  q.z = q.y > q.z ? q.y : q.z;
  q.w = q.z > q.w ? q.z : q.w;
  int32_t incl = q.w;  // the max over the lane's rows and those before in the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off && o > incl) incl = o;
  }
  int32_t floor = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) floor = -1;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  int32_t w = lane < warp ? warp_max[lane] : -1;  // the warps before, a lane each
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t o = __shfl_xor_sync(0xffffffffu, w, off);
    w = o > w ? o : w;
  }
  floor = w > floor ? w : floor;
  floor = least > floor ? least : floor;
  if (base < rows) {
    *own = make_int4(q.x > floor ? q.x : floor, q.y > floor ? q.y : floor,
                     q.z > floor ? q.z : floor, q.w > floor ? q.w : floor);
  }
}

// Form 3, the bank form (kD ≤ 8): block (x, y) writes rows [r0, r1) =
// [x·rows_per_tile, …) of trial y, one bank or a tile of one (see the
// header). It stages the starts below r1 (stage_starts), finds each row's
// source on chip, writes the sources to shared memory and copies the rows
// as the merge path does (copy_rows). kSearch (tiles of ≤ kBankThreads
// rows, a few banks): thread t searches row r0 + t in the staged starts.
// Else (tiles of ≤ kBankMaxRows rows, many banks): each staged start in
// [r0, r1) that ends its run of equal starts marks its row, the last start
// below r0 (the one whose successor is not below r0) is found in the same
// pass, and each row takes the last mark at or before it: thread t owns
// rows [4t, 4t + 4), scans them, and a warp scan of the threads' maxima
// and the maxima of the warps before finish it.
template <int kD, bool kVec, bool kSearch>
__global__ void __launch_bounds__(kBankThreads)
expand_bank(const int32_t* __restrict__ starts, int n_in,
            const float* __restrict__ values, const float* __restrict__ affine,
            float* __restrict__ out, int64_t n_out, int rows_per_tile) {
  extern __shared__ int4 bank_smem[];
  int32_t* warp_max = reinterpret_cast<int32_t*>(bank_smem);  // a slot a warp
  int32_t* before = warp_max + 32;                            // 4 slots, 1 used
  int32_t* source = before + 4;                               // rows_per_tile, 16-byte aligned
  const int64_t y = blockIdx.y;
  starts += y * n_in;
  values += y * n_in * kD;
  out += y * n_out * kD;
  if (affine != nullptr) affine += y * 2 * kD;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_tile;
  const int64_t r1 = r0 + rows_per_tile < n_out ? r0 + rows_per_tile : n_out;
  const int rows = static_cast<int>(r1 - r0);
  int32_t* window = source + ((rows_per_tile + 3) & ~3) +
                    ((reinterpret_cast<uintptr_t>(starts) >> 2) & 3);
  if constexpr (kSearch) {
    const int m = stage_starts(starts, n_in, r1, window);
    if (static_cast<int>(threadIdx.x) < rows) {
      // #{k < m : window[k] ≤ i}, by halving a (first, count) range.
      const int64_t i = r0 + threadIdx.x;
      const int32_t* first = window;
      int count = m;
      while (count > 0) {
        const int half = count >> 1;
        if (static_cast<int64_t>(first[half]) <= i) {
          first += half + 1;
          count -= half + 1;
        } else {
          count = half;
        }
      }
      const int c = static_cast<int>(first - window);
      source[threadIdx.x] = c > 0 ? c - 1 : 0;
    }
  } else {
    const int base = threadIdx.x * kBankRowsPerThread;  // the thread's first row
    int4* own = reinterpret_cast<int4*>(source) + threadIdx.x;
    if (base < rows) *own = make_int4(-1, -1, -1, -1);
    if (threadIdx.x == 0) *before = 0;
    const int m = stage_starts(starts, n_in, r1, window);
    for (int x = threadIdx.x; x < m; x += kBankThreads) {
      const int32_t v = window[x];
      // x + 1 < m here unless x + 1 == n_in: staging stopped at a start ≥ r1.
      if (v >= r1) continue;
      const bool last = x + 1 == n_in;
      if (v >= r0) {
        if (last || window[x + 1] != v) source[v - r0] = x;
      } else if (last || window[x + 1] >= r0) {
        *before = x;
      }
    }
    __syncthreads();
    fill_marks(source, rows, *before, warp_max);
  }
  __syncthreads();
  copy_rows<kBankThreads, kD, kVec>(source, rows, values, GlobalAffine<kD>{affine},
                                    out + r0 * kD);
}

// Dynamic shared memory of a bank-form block: 32 warp maxima and `before`
// (36 slots), rows_per_tile sources rounded up to 16 bytes, and n_in starts
// with up to 3 slots of alignment offset.
__host__ __device__ constexpr size_t bank_smem_bytes(int n_in, int rows_per_tile) {
  return 4 * (36 + ((static_cast<size_t>(rows_per_tile) + 3) & ~size_t{3}) + n_in + 3);
}

template <int kD, bool kVec, bool kSearch>
static int launch_bank(const int32_t* s, int n_in, const float* v, const float* a, float* o,
                       int64_t n_out, int n_trials, int tiles, int rows_per_tile,
                       cudaStream_t st) {
  const size_t bytes = bank_smem_bytes(n_in, rows_per_tile);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_bank<kD, kVec, kSearch>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_trials));
  expand_bank<kD, kVec, kSearch><<<grid, kBankThreads, bytes, st>>>(s, n_in, v, a, o, n_out,
                                                                    rows_per_tile);
  return 0;
}

// Tiles of at most kBankThreads rows are searched, larger ones scanned.
template <int kD>
static int launch_bank(const int32_t* s, int n_in, const float* v, const float* a, float* o,
                       int64_t n_out, int n_trials, int tiles, cudaStream_t st) {
  const int rows_per_tile = static_cast<int>((n_out + tiles - 1) / tiles);
  tiles = static_cast<int>((n_out + rows_per_tile - 1) / rows_per_tile);  // none empty
  const bool search = rows_per_tile <= kBankThreads;
  constexpr int kW = merge_width<kD, true>();
  const uintptr_t bits = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (kW > 1 && bits % (4 * kW) == 0) {
    return search ? launch_bank<kD, true, true>(s, n_in, v, a, o, n_out, n_trials, tiles,
                                                rows_per_tile, st)
                  : launch_bank<kD, true, false>(s, n_in, v, a, o, n_out, n_trials, tiles,
                                                 rows_per_tile, st);
  }
  return search ? launch_bank<kD, false, true>(s, n_in, v, a, o, n_out, n_trials, tiles,
                                               rows_per_tile, st)
                : launch_bank<kD, false, false>(s, n_in, v, a, o, n_out, n_trials, tiles,
                                                rows_per_tile, st);
}

constexpr int kBankWarps = kBankThreads / 32;
constexpr float kCdfQuant = 1073741824.0f;  // 2^30, the integer CDF's weight scale

// Reduces each of kK per-thread values over the block, sums or (kMax)
// maxima, in a fixed order: a butterfly in each warp, then the warps' in
// turn. Every thread gets the results in `v`. `partial` holds kBankWarps·kK
// floats and `total` kK, in a region of its own: a thread that returns
// may enter the next call, and write its partials, while another still
// reads this call's totals. The call starts with the block in step.
template <int kK, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kK], float* partial, float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = kMax ? fmaxf(v[k], o) : v[k] + o;
    }
    if (lane == 0) partial[warp * kK + k] = v[k];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < kK) {
    float r = partial[threadIdx.x];
    for (int w = 1; w < kBankWarps; ++w) {
      const float o = partial[w * kK + threadIdx.x];
      r = kMax ? fmaxf(r, o) : r + o;
    }
    total[threadIdx.x] = r;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kK; ++k) v[k] = total[k];
}

// The bank form with the Liu–West resample's prologue (kD ≤ 8, n ≤
// kBankMaxRows): block y resamples bank y whole, from its log-weights,
// its rows and its stratum offset u0[y], as LiuWestResampler.batched's
// eager chain does. Thread t owns rows [4t, 4t + 4) throughout.
//  1. The log-sum-exp as torch.logsumexp takes it (the maximum, 0 where
//     it is infinite, plus log Σ exp(lw − max)), then w = exp(lw − lse).
//  2. μ = Σ w·x, then Σ = Σ (w·(x − μ))(x − μ)ᵀ over the centred rows
//     (weighted_moments_batched's two passes), zero_cov on its diagonal;
//     written to mean and cov, and at kD = 1 root = √max(h²·Σ, 0) (what
//     sqrtm_psd gives for a 1 × 1 matrix).
//  3. The segment starts with _starts_from_weights' arithmetic: q =
//     rint(w·2^30) as int64, an exact inclusive scan (the thread's rows,
//     a warp scan, the warps before), total = max(Σ q, 1), scale = f32(n) /
//     f32(total), t = ceil(f32(icdf)·scale − u0), starts = [0, t[:−1]]
//     clamped at 0: written straight into shared memory, not to global.
//  4. The scanned bank form's marks and fill, and copy_rows with a·x +
//     (1 − a)·μ.
// A bank is one block, so its prologue is computed once, in one order.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kBankThreads)
expand_bank_liu_west(const float* __restrict__ log_w, int n, const float* __restrict__ values,
                     const float* __restrict__ u0, float a, float one_minus_a, float h2,
                     float zero_cov, float* __restrict__ out, float* __restrict__ mean,
                     float* __restrict__ cov, float* __restrict__ root) {
  constexpr int kPairs = kD * (kD + 1) / 2;  // Σ's entries on and above the diagonal
  constexpr int kR = kBankRowsPerThread;
  __shared__ __align__(16) int32_t source[kBankMaxRows];
  __shared__ int32_t window[kBankMaxRows];
  __shared__ float partial[kBankWarps * kPairs];
  __shared__ float total_of[kPairs];
  __shared__ float shift[kD];
  __shared__ long long warp_sum[kBankWarps];
  __shared__ int32_t warp_max[kBankWarps];
  const int64_t y = blockIdx.x;
  log_w += y * n;
  values += y * n * kD;
  out += y * n * kD;
  const int base = threadIdx.x * kR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float lw[kR], x[kR][kD];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool in = base + r < n;
    lw[r] = in ? __ldg(log_w + base + r) : -INFINITY;
#pragma unroll
    for (int d = 0; d < kD; ++d) x[r][d] = in ? __ldg(values + (base + r) * kD + d) : 0.0f;
  }

  // 1. The normalised weights.
  float mx[1] = {lw[0]};
#pragma unroll
  for (int r = 1; r < kR; ++r) mx[0] = fmaxf(mx[0], lw[r]);
  block_reduce<1, true>(mx, partial, total_of);
  const float m = fabsf(mx[0]) == INFINITY ? 0.0f : mx[0];
  float sum[1] = {0.0f};
#pragma unroll
  for (int r = 0; r < kR; ++r) sum[0] += expf(lw[r] - m);
  block_reduce<1, false>(sum, partial, total_of);
  const float lse = logf(sum[0]) + m;
  float w[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) w[r] = base + r < n ? expf(lw[r] - lse) : 0.0f;

  // 2. The moments.
  float mu[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    mu[d] = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) mu[d] += w[r] * x[r][d];
  }
  block_reduce<kD, false>(mu, partial, total_of);
  float sigma[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) sigma[k] = 0.0f;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float c[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) c[d] = x[r][d] - mu[d];
    int k = 0;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float wc = w[r] * c[d];
#pragma unroll
      for (int e = d; e < kD; ++e) sigma[k++] += wc * c[e];
    }
  }
  block_reduce<kPairs, false>(sigma, partial, total_of);
  if (threadIdx.x == 0) {
    float* cov_y = cov + y * kD * kD;
    int k = 0;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      shift[d] = __fmul_rn(one_minus_a, mu[d]);
      mean[y * kD + d] = mu[d];
#pragma unroll
      for (int e = d; e < kD; ++e, ++k) {
        const float v = d == e ? __fadd_rn(sigma[k], zero_cov) : sigma[k];
        cov_y[d * kD + e] = v;
        cov_y[e * kD + d] = v;
      }
    }
    if (root != nullptr) root[y] = sqrtf(fmaxf(__fmul_rn(h2, __fadd_rn(sigma[0], zero_cov)), 0.0f));
  }

  // 3. The segment starts.
  long long icdf[kR], run = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    run += base + r < n ? __float2ll_rn(__fmul_rn(w[r], kCdfQuant)) : 0;
    icdf[r] = run;  // within the thread's rows
  }
  long long incl = run;  // over the warp's threads up to this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  int4* own = reinterpret_cast<int4*>(source) + threadIdx.x;
  if (base < n) *own = make_int4(-1, -1, -1, -1);
  __syncthreads();
  long long before = incl - run, total = 0;
  for (int k = 0; k < kBankWarps; ++k) {
    before += k < warp ? warp_sum[k] : 0;
    total += warp_sum[k];
  }
  total = total > 1 ? total : 1;
  const float scale = __fdiv_rn(static_cast<float>(n), __ll2float_rn(total));
  const float u = __ldg(u0 + y);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (base + r + 1 < n) {
      const float t = ceilf(__fsub_rn(__fmul_rn(__ll2float_rn(before + icdf[r]), scale), u));
      window[base + r + 1] = static_cast<int32_t>(t > 0.0f ? t : 0.0f);
    }
  }
  if (threadIdx.x == 0) window[0] = 0;
  __syncthreads();

  // 4. The expand: each start that ends its run of equal starts marks its row.
  for (int k = threadIdx.x; k < n; k += kBankThreads) {
    const int32_t v = window[k];
    if (v < n && (k + 1 == n || window[k + 1] != v)) source[v] = k;
  }
  __syncthreads();
  fill_marks(source, n, 0, warp_max);
  __syncthreads();
  copy_rows<kBankThreads, kD, kVec>(source, n, values, Shrink{a, shift}, out);
}

template <int kD>
static void launch_liu_west(const float* lw, int n, const float* v, const float* u0, float a,
                            float one_minus_a, float h2, float zero_cov, float* o, float* mean,
                            float* cov, float* root, int n_trials, cudaStream_t st) {
  constexpr int kW = merge_width<kD, true>();
  const uintptr_t bits = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (kW > 1 && bits % (4 * kW) == 0) {
    expand_bank_liu_west<kD, true><<<n_trials, kBankThreads, 0, st>>>(
        lw, n, v, u0, a, one_minus_a, h2, zero_cov, o, mean, cov, root);
  } else {
    expand_bank_liu_west<kD, false><<<n_trials, kBankThreads, 0, st>>>(
        lw, n, v, u0, a, one_minus_a, h2, zero_cov, o, mean, cov, root);
  }
}

}  // namespace

// n_trials banks, each: starts int32 (n_in,); values f32 (n_in, n_cols)
// row-major; affine f32 (2, n_cols) [scale; shift] or NULL; out f32 (n_out,
// n_cols). The banks lie back to back (trial y's arrays start y times their
// size after trial 0's). form: 0 one thread per row, 1 a warp per span of
// 32 rows, 2 the merge path (n_cols ≤ 8), 3 the bank form (n_cols ≤ 8,
// n_in ≤ 2^15, `tiles` blocks a trial of at most 2048 rows each; `tiles`
// is read by no other form). n_in < 2^31. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int qt_expand(const void* starts, int64_t n_in, const void* values,
                         int n_cols, const void* affine, void* out, int64_t n_out,
                         int n_trials, int form, int tiles, void* stream) {
  if (n_in <= 0 || n_in > INT32_MAX || n_cols <= 0 || n_out <= 0 || n_trials <= 0 ||
      n_trials > 65535 || form < 0 || form > 3 || (form >= 2 && n_cols > 8) ||
      (form == 3 && (n_in > kBankCap || tiles <= 0 || tiles > n_out ||
                     (n_out + tiles - 1) / tiles > kBankMaxRows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_trials));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(starts);
  const auto* v = static_cast<const float*>(values);
  const auto* a = static_cast<const float*>(affine);
  auto* o = static_cast<float*>(out);
  if (form == 3) {
    const int n = static_cast<int>(n_in);
    int err;
    switch (n_cols) {
      case 1: err = launch_bank<1>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 2: err = launch_bank<2>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 3: err = launch_bank<3>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 4: err = launch_bank<4>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 5: err = launch_bank<5>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 6: err = launch_bank<6>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      case 7: err = launch_bank<7>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
      default: err = launch_bank<8>(s, n, v, a, o, n_out, n_trials, tiles, st); break;
    }
    if (err != 0) return err;
  } else if (form == 2) {
    switch (n_cols) {
      case 1: launch_merge<1>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 2: launch_merge<2>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 3: launch_merge<3>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 4: launch_merge<4>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 5: launch_merge<5>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 6: launch_merge<6>(s, n_in, v, a, o, n_out, n_trials, st); break;
      case 7: launch_merge<7>(s, n_in, v, a, o, n_out, n_trials, st); break;
      default: launch_merge<8>(s, n_in, v, a, o, n_out, n_trials, st); break;
    }
  } else if (form == 0) {
    expand_rows<<<grid, kThreads, 0, st>>>(s, n_in, v, n_cols, a, o, n_out);
  } else if (n_cols % 4 == 0 &&
             ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(a) |
               reinterpret_cast<uintptr_t>(o)) & 15) == 0) {
    expand_span<true><<<grid, kThreads, 0, st>>>(s, n_in, v, n_cols, a, o, n_out);
  } else {
    expand_span<false><<<grid, kThreads, 0, st>>>(s, n_in, v, n_cols, a, o, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Liu–West resample of n_trials banks (expand_bank_liu_west), each:
// log_w f32 (n,), values f32 (n, n_cols) row-major, u0 f32 (one a bank);
// out f32 (n, n_cols), mean f32 (n_cols,), cov f32 (n_cols, n_cols), root
// f32 (one a bank, h·Σ^{1/2} at n_cols = 1) or NULL. The banks lie back to
// back. scale a, shift one_minus_a·μ, h2 = h², zero_cov added to Σ's
// diagonal. 1 ≤ n ≤ 2048, n_cols ≤ 8. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int qt_liu_west_expand(const void* log_w, int n, const void* values, int n_cols,
                                  const void* u0, float a, float one_minus_a, float h2,
                                  float zero_cov, void* out, void* mean, void* cov, void* root,
                                  int n_trials, void* stream) {
  if (n <= 0 || n > kBankMaxRows || n_cols <= 0 || n_cols > 8 || n_trials <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const float*>(log_w);
  const auto* v = static_cast<const float*>(values);
  const auto* u = static_cast<const float*>(u0);
  auto* o = static_cast<float*>(out);
  auto* mu = static_cast<float*>(mean);
  auto* c = static_cast<float*>(cov);
  auto* r = static_cast<float*>(root);
  switch (n_cols) {
    case 1: launch_liu_west<1>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 2: launch_liu_west<2>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 3: launch_liu_west<3>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 4: launch_liu_west<4>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 5: launch_liu_west<5>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 6: launch_liu_west<6>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    case 7: launch_liu_west<7>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
    default: launch_liu_west<8>(lw, n, v, u, a, one_minus_a, h2, zero_cov, o, mu, c, r, n_trials, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
