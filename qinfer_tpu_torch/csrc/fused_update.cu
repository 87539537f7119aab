// Fused Bayes update (B1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel qinfer_tpu/ops/fused_update.py:36
// (_update_kernel, launched at :156 by fused_bayes_update). For a pluggable
// likelihood tile it computes, in one read of the bank,
//     lw_i = log_w_i + max(log L_i, -87)            (written out unnormalized)
//     lse  = log Σ exp(lw),   lse2 = log Σ exp(2·lw),   ess = exp(2·lse − lse2)
//
// What bounds it on this card: memory. Per particle it reads log_w and one
// to sixteen parameter columns and writes lw: 12 to 72 bytes, 4 to 23 µs
// for 2^20 particles at 3.35 TB/s; the cos/log/exp per element are far below
// the SMs' rate. At that size the two launches cost as much as the traffic.
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
// Trials. An ensemble of T independent banks (the JAX package's custom_vmap
// rule, fused_update.py:197-209, which lax.maps the kernel over the trials
// or falls back to XLA below 2^17 particles) is one launch on a (block,
// trial) grid: blockIdx.y picks the trial's scalars row, log-weights and
// columns, pass 1 writes a partials row per trial, and pass 2 runs one
// block per trial over its row in the same fixed order. Each trial's result
// is therefore bit-equal to a single-bank launch on it, and every bank size
// runs the kernel. A single bank (T = 1) keeps its own instantiation, in
// which nothing is shifted: with the trial offsets, the one-column tiles
// took 0.5–1.1 µs more at 2^20 on an H100 (chip_profile.py --parent).
//
// The likelihood is a device functor: an outcome composition over a pr1
// functor, the tiles of fused_update.py:247-356. TwoOutcome<Pr1> is
// two_outcome_tile (:247), Binomial<Pr1> is binomial_tile (:259, log C(n,k)
// comes in `scalars`, computed on the device by the wrapper). The pr1
// functors are precession (:280), multicos (:286), known-T2 (:299), RB
// (:311), interleaved RB (:319), inversion (:330), coin (:336), noisy
// coin (:342) and the tomography Born rule make_born_pr1 (:347, up to 16
// columns). Each reads its expparams from `scalars` once per thread and its
// compile-time constants (known-T2's T2) from `consts`, passed by value.
// Products and sums are rounded one by one (__fmul_rn, __fadd_rn: no FMA
// contraction), as the plain PyTorch version of the same function computes
// them.
//
// Columns are read in place: column j of particle i is p[j][i·stride[j]].
// The parameter columns of a model are views of one (N, D) row-major bank,
// so every stride is D and no column is copied out first. Each functor
// names its own column bound (kMaxColsUsed), so a wide functor does not
// widen the unrolled loops or the registers of the others: MultiCos keeps
// 8, and the Born rule is instantiated at 4 columns (a qubit) and at 16
// (two qubits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;      // the widest functor (Born, two qubits)
constexpr int kMultiCosMaxCols = 8;
constexpr int kMaxConsts = 4;
constexpr float kNegBig = -3.0e38f;
constexpr float kLogTiny = -87.0f;

// Column j of particle i is p[j][i * stride[j]].
struct Cols {
  const float* p[kMaxCols];
  int64_t stride[kMaxCols];
  __device__ __forceinline__ float operator()(int j, int64_t i) const {
    return p[j][i * stride[j]];
  }
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

// -- pr1 functors: Pr(outcome 1) of one particle. `s` points at the pr1
// function's own scalars (after the outcome composition's head).

// 1 − cos²(0.5·ω·t); s = [t]; one column, omega.
struct PrecessionPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float t;
  __device__ PrecessionPr1(const float* s, const Consts&, int) : t(s[0]) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    return one_minus_cos2(mul(mul(0.5f, c(0, i)), t));
  }
};

// 1 − cos²(0.5·Σ ω_j t_j), summed in the order ω₀t₀ + ω₁t₁ + …;
// s = ts (n_terms = n_cols).
struct MultiCosPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = kMultiCosMaxCols;
  float ts[kMaxColsUsed];
  int n_terms;
  __device__ MultiCosPr1(const float* s, const Consts&, int n_cols) : n_terms(n_cols) {
#pragma unroll
    for (int j = 0; j < kMaxColsUsed; ++j) ts[j] = j < n_cols ? s[j] : 0.0f;
  }
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    float arg = mul(c(0, i), ts[0]);
#pragma unroll
    for (int j = 1; j < kMaxColsUsed; ++j) {
      if (j < n_terms) arg = add(arg, mul(c(j, i), ts[j]));
    }
    return one_minus_cos2(mul(0.5f, arg));
  }
};

// 1 − (d·cos²(0.5·ω·t) + 0.5·(1 − d)), d = exp(−t / T2); s = [t]; consts = [T2].
struct KnownT2Pr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float t, damp, mix;
  __device__ KnownT2Pr1(const float* s, const Consts& k, int)
      : t(s[0]), damp(expf(-s[0] / k.v[0])),  // IEEE division (no fast-math)
        mix(mul(0.5f, sub(1.0f, damp))) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    const float co = cosf(mul(mul(0.5f, c(0, i)), t));
    return sub(1.0f, add(mul(mul(damp, co), co), mix));
  }
};

// 1 − clip(A·decayᵐ + B, 0, 1), decayᵐ = exp(m·log(clip(decay, 1e-20, 1))).
__device__ __forceinline__ float rb_pr1(float m, float decay, float a, float b) {
  const float dm = expf(mul(m, logf(clampf(decay, 1e-20f, 1.0f))));
  return sub(1.0f, clampf(add(mul(a, dm), b), 0.0f, 1.0f));
}

// s = [m]; columns p, A, B.
struct RbPr1 {
  static constexpr int kMinCols = 3, kMaxColsUsed = 3;
  float m;
  __device__ RbPr1(const float* s, const Consts&, int) : m(s[0]) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    return rb_pr1(m, c(0, i), c(1, i), c(2, i));
  }
};

// s = [m, reference]; columns p̃, p_ref, A, B; decay p_ref if reference == 1
// else p̃·p_ref.
struct RbInterleavedPr1 {
  static constexpr int kMinCols = 4, kMaxColsUsed = 4;
  float m;
  bool reference;
  __device__ RbInterleavedPr1(const float* s, const Consts&, int)
      : m(s[0]), reference(s[1] == 1.0f) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    const float p_ref = c(1, i);
    const float decay = reference ? p_ref : mul(c(0, i), p_ref);
    return rb_pr1(m, decay, c(2, i), c(3, i));
  }
};

// 1 − cos²(0.5·(ω − ω_)·t); s = [ω_, t].
struct InversionPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float w, t;
  __device__ InversionPr1(const float* s, const Consts&, int) : w(s[0]), t(s[1]) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    return one_minus_cos2(mul(mul(0.5f, sub(c(0, i), w)), t));
  }
};

// p; no scalars.
struct CoinPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  __device__ CoinPr1(const float*, const Consts&, int) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    return c(0, i);
  }
};

// 1 − (α·(1 − p) + β·p); s = [α, β].
struct NoisyCoinPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float alpha, beta;
  __device__ NoisyCoinPr1(const float* s, const Consts&, int) : alpha(s[0]), beta(s[1]) {}
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    const float p = c(0, i);
    return sub(1.0f, add(mul(alpha, sub(1.0f, p)), mul(beta, p)));
  }
};

// Born rule: clip(x₀e₀ + x₁e₁ + … + x_{n−1}e_{n−1}, 0, 1), summed in that
// order; s = meas (the effect's n_cols coordinates); columns x_d. Bounded
// at kCols columns: d² = 4 for a qubit, 16 for two.
template <int kCols>
struct BornPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = kCols;
  float e[kMaxColsUsed];
  int n;
  __device__ BornPr1(const float* s, const Consts&, int n_cols) : n(n_cols) {
#pragma unroll
    for (int j = 0; j < kMaxColsUsed; ++j) e[j] = j < n_cols ? s[j] : 0.0f;
  }
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
    float acc = mul(c(0, i), e[0]);
#pragma unroll
    for (int j = 1; j < kMaxColsUsed; ++j) {
      if (j < n) acc = add(acc, mul(c(j, i), e[j]));
    }
    return clampf(acc, 0.0f, 1.0f);
  }
};

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
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
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
  __device__ __forceinline__ float operator()(const Cols& c, int64_t i) const {
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

// One block per trial (blockIdx.x): stats row = [lse, lse2, log_norm (= lse), ess].
__global__ void __launch_bounds__(kThreads)
fused_update_pass2(const float* __restrict__ partials, int n_blocks,
                   float* __restrict__ stats) {
  partials += static_cast<int64_t>(blockIdx.x) * 3 * n_blocks;
  stats += 4 * static_cast<int64_t>(blockIdx.x);
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

// What one launch needs besides the functor: the device pointers and the
// (n_blocks, n_trials) grid.
struct Launch {
  const float* scalars;
  int scalar_stride;
  Consts consts;
  int n_cols;
  const float* log_w;
  Cols cols;
  int64_t trial_stride;
  float* out;
  float* partials;
  int n_blocks;
  int n_trials;
  int64_t n;
  cudaStream_t stream;
};

template <class Tile>
static int launch(const Launch& a) {
  if (a.n_cols < Tile::P::kMinCols || a.n_cols > Tile::P::kMaxColsUsed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n_trials == 1) {
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

template <template <class> class Outcome>
static int launch_pr1(int pr1, const Launch& a) {
  switch (pr1) {
    case 0: return launch<Outcome<PrecessionPr1>>(a);
    case 1: return launch<Outcome<MultiCosPr1>>(a);
    case 2: return launch<Outcome<KnownT2Pr1>>(a);
    case 3: return launch<Outcome<RbPr1>>(a);
    case 4: return launch<Outcome<RbInterleavedPr1>>(a);
    case 5: return launch<Outcome<InversionPr1>>(a);
    case 6: return launch<Outcome<CoinPr1>>(a);
    case 7: return launch<Outcome<NoisyCoinPr1>>(a);
    case 8:
      return a.n_cols <= 4 ? launch<Outcome<BornPr1<4>>>(a)
                           : launch<Outcome<BornPr1<kMaxCols>>>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// outcome: 0 = TwoOutcome, 1 = Binomial. pr1: the functor ids of
// ops/fused_update.py (0 precession … 7 noisy coin, 8 Born). consts: host
// array of n_consts floats. cols, col_strides: host arrays of n_cols device
// pointers and their element strides. n_trials banks of n particles:
// scalars (n_trials, scalar_stride), log_w and out_lw (n_trials, n), column
// j of trial y starts trial_stride elements after trial y − 1's; partials:
// 3·n_blocks·n_trials floats; stats: 4·n_trials floats. One bank is
// n_trials = 1 (the strides are then not read). Returns the cudaError_t of
// the launches (0 on success).
extern "C" int qt_fused_update(int outcome, int pr1, const void* scalars,
                               int scalar_stride, const void* consts, int n_consts,
                               const void* log_w, const void* const* cols,
                               const int64_t* col_strides, int n_cols,
                               int64_t trial_stride, void* out_lw, void* partials,
                               int n_blocks, void* stats, int64_t n, int n_trials,
                               void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || n_consts < 0 || n_consts > kMaxConsts ||
      n_blocks <= 0 || n <= 0 || n_trials <= 0 || n_trials > 65535 ||
      scalar_stride < 0 || trial_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{};
  for (int j = 0; j < n_cols; ++j) {
    if (col_strides[j] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.cols.p[j] = static_cast<const float*>(cols[j]);
    a.cols.stride[j] = col_strides[j];
  }
  for (int j = 0; j < n_consts; ++j) a.consts.v[j] = static_cast<const float*>(consts)[j];
  a.scalars = static_cast<const float*>(scalars);
  a.scalar_stride = scalar_stride;
  a.n_cols = n_cols;
  a.log_w = static_cast<const float*>(log_w);
  a.trial_stride = trial_stride;
  a.out = static_cast<float*>(out_lw);
  a.partials = static_cast<float*>(partials);
  a.n_blocks = n_blocks;
  a.n_trials = n_trials;
  a.n = n;
  a.stream = static_cast<cudaStream_t>(stream);
  int err;
  switch (outcome) {
    case 0: err = launch_pr1<TwoOutcome>(pr1, a); break;
    case 1: err = launch_pr1<Binomial>(pr1, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  fused_update_pass2<<<n_trials, kThreads, 0, a.stream>>>(
      a.partials, n_blocks, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}
