// Fused Bayes update (B1) for Hopper, sm_90a: the built-in library.
//
// The kernels, their launch and their note (which TPU kernel they replace,
// what bounds them, how they are laid out) are in fused_update.cuh. This
// file holds the port's own pr1 functors, the tiles of
// qinfer_tpu/ops/fused_update.py: precession (:280), multicos (:286),
// known-T2 (:299), RB (:311), interleaved RB (:319), inversion (:330),
// coin (:336), noisy coin (:342) and the tomography Born rule
// make_born_pr1 (:347, up to 16 columns), and GivenPr1, the column route's
// functor: Pr(1) evaluated by the model's own torch pr1 and handed in as
// the one column (ops/fused_update.py). Each reads its expparams from
// `scalars` once per thread and its compile-time constants (known-T2's T2)
// from `consts`. A functor names its own column bound (kMaxColsUsed), so a
// wide functor does not widen the unrolled loops or the registers of the
// others: MultiCos keeps 8, and the Born rule is instantiated at 4 columns
// (a qubit) and at 16 (two qubits).

#include "fused_update.cuh"

namespace {

constexpr int kMultiCosMaxCols = 8;

// -- pr1 functors: Pr(outcome 1) of one particle. `s` points at the pr1
// function's own scalars (after the outcome composition's head).

// 1 − cos²(0.5·ω·t); s = [t]; one column, omega.
struct PrecessionPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float t;
  __device__ PrecessionPr1(const float* s, const Consts&, int) : t(s[0]) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    return one_minus_cos2(mul(mul(0.5f, sub(c(0, i), w)), t));
  }
};

// p; no scalars.
struct CoinPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  __device__ CoinPr1(const float*, const Consts&, int) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    return c(0, i);
  }
};

// 1 − (α·(1 − p) + β·p); s = [α, β].
struct NoisyCoinPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  float alpha, beta;
  __device__ NoisyCoinPr1(const float* s, const Consts&, int) : alpha(s[0]), beta(s[1]) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
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
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    float acc = mul(c(0, i), e[0]);
#pragma unroll
    for (int j = 1; j < kMaxColsUsed; ++j) {
      if (j < n) acc = add(acc, mul(c(j, i), e[j]));
    }
    return clampf(acc, 0.0f, 1.0f);
  }
};

// Pr(1) given as the one column: the column route, for a model whose pr1 has
// no CUDA functor; no scalars.
struct GivenPr1 {
  static constexpr int kMinCols = 1, kMaxColsUsed = 1;
  __device__ GivenPr1(const float*, const Consts&, int) {}
  template <class C>
  __device__ __forceinline__ float operator()(const C& c, int64_t i) const {
    return c(0, i);
  }
};

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
    case 9: return launch<Outcome<GivenPr1>>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The functor ids of ops/fused_update.py: 0 precession … 7 noisy coin,
// 8 Born, 9 GivenPr1.
struct BuiltIn {
  static int run(int outcome, int pr1, const Launch& a) {
    switch (outcome) {
      case 0: return launch_pr1<TwoOutcome>(pr1, a);
      case 1: return launch_pr1<Binomial>(pr1, a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace

QT_FUSED_UPDATE_ENTRIES(BuiltIn)
