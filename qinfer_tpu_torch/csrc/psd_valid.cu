// The validity test of d-level tomography (d = 3, 4) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package tests positivity with the
// characteristic polynomial of the real embedding in plain jnp
// (qinfer_tpu/tomography/models.py:_psd_via_charpoly), which XLA fuses. The
// port's test (ops/psd_valid.py:psd_valid_plain) builds ρ from the
// coordinates with two matrix products and factors ρ + psd_tol·I by LDLᴴ in
// d − 1 rank-one Schur steps of about sixteen elementwise launches each:
// 35–57 launches and their host time a test, and a Liu–West resample under
// postselection tests its whole bank ≈ 14 times. This kernel is the same
// test in one launch. For each row of coordinates x (d² f32 values, row
// stride `row_stride`) it writes one byte:
//     ok = [every pivot of LDLᴴ(ρ + tol·I) > 0] ∧ [trace test on x₀]
// with ρ = Σ_i x_i B_i, the trace test |x₀ − 1/√d| < 1e-4, or x₀ ≤ 1/√d +
// 1e-5 for subnormalised states (the two thresholds come rounded to f32
// from the wrapper, as torch rounds them).
//
// What bounds it on this card: memory. A row is read once, 4·d² bytes, and
// one byte is written: 68.2 MB at 2^20 rows and d = 4, ≈ 20.3 µs at 3.35
// TB/s. The arithmetic is 2·d⁴ products for ρ (512 at d = 4) and a 4 × 4
// factorization, ≈ 0.6 GFLOP at 2^20 rows, ≈ 9 µs at the f32 rate.
//
// Design. A block of 256 threads takes 256 rows. It stages them through
// shared memory: thread t loads the block's flat element t, t + 256, …, so
// neighbouring lanes read neighbouring words, coalesced at any row stride
// (the view modelparams[:, :-1] of the diffusive model has stride d² + 1),
// into rows of an odd pitch, so that a warp reading its 32 rows hits 32
// banks; rows that lie back to back (unit row stride) are read as one
// contiguous span. Then one thread a row. The basis is a kernel parameter
// (2·d⁴ floats: 2 KB at d = 4) and every loop is unrolled, so each
// coefficient is an operand from the constant bank and not a load. ρ's
// lower triangle is built in registers (the real part on and below the
// diagonal, the imaginary part below it: all that the factorization reads),
// each entry a sum over the d² coordinates in order; the coordinates are
// the outer loop, so each is read from the tile once while the d² sums stay
// in registers. With the sums as the outer loop ptxas kept 32 registers and
// the kernel took 56.6 µs at 2^20 rows, d = 4, on an H100; this order
// takes 40 registers and 40.6 µs (17.8 µs at d = 3, against 11.6).
// The factorization repeats the plain version's arithmetic step for step:
// the same pivot order, no pivoting, inv = 1/p (1 where p ≤ 0 or NaN), and
// each update rounded as its own product, sum and difference (no FMA
// contraction), as torch's elementwise launches round them; so on the same
// ρ the two take the same decisions. Only ρ's entries differ from the
// matrix products' (another order of the same sum, an ulp or so), which
// moves the threshold by far less than the factorization's own ≈
// d·eps·‖ρ‖.
//
// The redraw round (psd_redraw_rows, ops/psd_valid.py:psd_redraw). A round
// of Liu–West postselection redraws the rows still invalid: the resampler
// draws the whole bank's noise ε (one draw of its shape, so the stream of
// draws is the masked chain's), and this kernel, for each row still
// invalid, smears x = centers[i] + S·ε[i] (S = h·Σ^{1/2}, one for the bank
// or one for each bank of a flattened (T·N, d²) stack), tests x with the
// same device code (is_state), and where x is a state writes it and its
// byte of ok, else lists i and counts it in `left`, the round's one host
// read. It replaces the masked chain (the GEMM ε·Sᵀ, its add, the test of
// the whole bank, ~ok, &, where, |: ≈ 270 µs at 2^20 rows, d = 4) and its
// eight launches.
//
// What bounds it: the rows still invalid, each a gather of its 2·d² noise
// and center floats and a scatter of its row or its index, with d⁴
// products for the smear and the test's 2·d⁴ + d³ on top (≈ 1.3k flops a
// row at d = 4). The roofline is tiny (≈ 0.8 µs at 2^14 rows); the launch
// and the load of a partly filled grid bound it: 7.4 µs with 20 rows
// left, 11.9 µs with 2^14, 95 µs with 2^19 (d = 4, 2^20 rows, H100).
//
// Layout. One thread a row: the row's noise and center from global memory
// (L1 serves a row's 64 bytes to its thread), S's d⁴ floats by __ldg (the
// same address across a warp whose rows share a bank: one broadcast), the
// smear in registers as one FMA chain over the columns in order from 0,
// then the center added, which is how cuBLAS rounds the GEMM and torch the
// add on all but a few rows in 10^5 (0.25 ulp of the row's scale at most).
// The first round walks the mask (every row, those valid return at once);
// it and each later round list the rows left by atomicAdd on `left`, and a
// later round walks only that list. Measured at 2^20 rows, d = 4, with 2^14
// rows left scattered through the bank, each form timed first and then
// second in one run: the mask walk takes 33.5 µs (a warp holds half a row
// to test, and idles the rest of its lanes), the list 11.9 µs (d = 3: 15.4
// against 7.9); with 20 left 9.2 against 7.4; with half the bank left
// 106.7 against 95.4. So the first round, where only the mask exists,
// walks it, and every later one the list. 48 registers at d = 4, 32 at
// d = 3.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// The basis' real and imaginary parts, [element][a·d + b], as
// TomographyBasis.re_im holds them.
template <int D>
struct Basis {
  float re[D * D][D * D];
  float im[D * D][D * D];
};

// The test of one row x (d² coordinates) in registers or shared memory:
// ok = [every pivot of LDLᴴ(ρ + tol·I) > 0] ∧ [trace test on x₀].
template <int D>
__device__ __forceinline__ bool is_state(const float* x, const Basis<D>& basis, float tol,
                                         float trace_target, float trace_bound,
                                         int subnormalized) {
  constexpr int kEl = D * D;
  // ρ's lower triangle: ar on and below the diagonal, ai below it.
  float ar[D][D] = {}, ai[D][D] = {};
  const float x0 = x[0];
#pragma unroll
  for (int i = 0; i < kEl; ++i) {
    const float xi = i == 0 ? x0 : x[i];
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        ar[a][b] = fmaf(xi, basis.re[i][a * D + b], ar[a][b]);
        if (a != b) ai[a][b] = fmaf(xi, basis.im[i][a * D + b], ai[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) ar[a][a] = __fadd_rn(ar[a][a], tol);

  // LDLᴴ of ρ + tol·I: step k takes pivot p = A[k][k] and updates the
  // trailing block A ← A − c·cᴴ/p with c the column below p,
  // c_i·conj(c_j) = (cr_i·cr_j + ci_i·ci_j) + i·(ci_i·cr_j − cr_i·ci_j).
  bool ok = ar[0][0] > 0.0f;
#pragma unroll
  for (int k = 0; k < D - 1; ++k) {
    const float p = ar[k][k];
    const float inv = 1.0f / (p > 0.0f ? p : 1.0f);
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
#pragma unroll
      for (int j = k + 1; j <= i; ++j) {
        const float cri = ar[i][k], cii = ai[i][k], crj = ar[j][k], cij = ai[j][k];
        ar[i][j] = __fsub_rn(ar[i][j], __fmul_rn(__fadd_rn(__fmul_rn(cri, crj),
                                                           __fmul_rn(cii, cij)), inv));
        if (i != j) {
          ai[i][j] = __fsub_rn(ai[i][j], __fmul_rn(__fsub_rn(__fmul_rn(cii, crj),
                                                             __fmul_rn(cri, cij)), inv));
        }
      }
    }
    ok = ok && ar[k + 1][k + 1] > 0.0f;
  }

  const bool trace_ok = subnormalized ? x0 <= trace_bound
                                      : fabsf(__fsub_rn(x0, trace_target)) < trace_bound;
  return ok && trace_ok;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
psd_valid_rows(const float* __restrict__ coords, int64_t n, int64_t row_stride,
               const __grid_constant__ Basis<D> basis, float tol, float trace_target,
               float trace_bound, int subnormalized, uint8_t* __restrict__ out) {
  constexpr int kEl = D * D;
  constexpr int kPitch = kEl | 1;  // odd: a warp's 32 rows on 32 banks
  __shared__ float tile[kThreads * kPitch];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(n - row0 < kThreads ? n - row0 : kThreads);
  if (row_stride == kEl) {  // the block's rows are one contiguous span
    const float* span = coords + row0 * kEl;
#pragma unroll
    for (int it = 0; it < kEl; ++it) {
      const int k = it * kThreads + threadIdx.x;
      if (k < rows * kEl) tile[(k / kEl) * kPitch + k % kEl] = __ldg(span + k);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kEl; ++it) {
      const int k = it * kThreads + threadIdx.x;
      const int r = k / kEl;
      if (r < rows) tile[r * kPitch + k % kEl] = __ldg(coords + (row0 + r) * row_stride + k % kEl);
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  out[row0 + r] = is_state<D>(tile + r * kPitch, basis, tol, trace_target, trace_bound,
                              subnormalized) ? 1 : 0;
}

// One redraw round of postselection on the rows still invalid: row i of
// the list `rows_in` (n of them), or with no list every row of the n that
// `ok` marks invalid. x = centers[i] + S·ε[i] with S the root of row i's
// bank (the bank of rows_per_root rows that holds i), the same test, and
// where x is a state, locs[i] = x and ok[i] = 1; else i goes to
// rows_out[atomicAdd(left, 1)], so `left` counts the rows still invalid.
template <int D>
__global__ void __launch_bounds__(kThreads)
psd_redraw_rows(float* __restrict__ locs, uint8_t* __restrict__ ok,
                const float* __restrict__ centers, const float* __restrict__ root,
                const float* __restrict__ noise, const int* __restrict__ rows_in, int64_t n,
                int64_t rows_per_root, const __grid_constant__ Basis<D> basis, float tol,
                float trace_target, float trace_bound, int subnormalized,
                int* __restrict__ rows_out, int* __restrict__ left) {
  constexpr int kEl = D * D;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n) return;
  const int64_t i = rows_in != nullptr ? rows_in[k] : k;
  if (rows_in == nullptr && ok[i]) return;
  const float* s = root + (i / rows_per_root) * (kEl * kEl);
  float eps[kEl], x[kEl];
#pragma unroll
  for (int b = 0; b < kEl; ++b) eps[b] = __ldg(noise + i * kEl + b);
  // The smear as cuBLAS rounds the GEMM ε·Sᵀ (but for a few rows in 10^5)
  // and torch the add: one FMA chain over the columns in order from 0, then
  // the center added.
#pragma unroll
  for (int a = 0; a < kEl; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < kEl; ++b) acc = fmaf(eps[b], __ldg(s + a * kEl + b), acc);
    x[a] = __fadd_rn(__ldg(centers + i * kEl + a), acc);
  }
  if (is_state<D>(x, basis, tol, trace_target, trace_bound, subnormalized)) {
#pragma unroll
    for (int a = 0; a < kEl; ++a) locs[i * kEl + a] = x[a];
    ok[i] = 1;
  } else {
    rows_out[atomicAdd(left, 1)] = static_cast<int>(i);
  }
}

template <int D>
void launch(const float* coords, int64_t n, int64_t row_stride, const float* basis, float tol,
            float trace_target, float trace_bound, int subnormalized, uint8_t* out,
            cudaStream_t stream) {
  Basis<D> b;
  memcpy(&b, basis, sizeof(b));
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  psd_valid_rows<D><<<blocks, kThreads, 0, stream>>>(coords, n, row_stride, b, tol, trace_target,
                                                     trace_bound, subnormalized, out);
}

template <int D>
void launch_redraw(float* locs, uint8_t* ok, const float* centers, const float* root,
                   const float* noise, const int* rows_in, int64_t n, int64_t rows_per_root,
                   const float* basis, float tol, float trace_target, float trace_bound,
                   int subnormalized, int* rows_out, int* left, cudaStream_t stream) {
  Basis<D> b;
  memcpy(&b, basis, sizeof(b));
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  psd_redraw_rows<D><<<blocks, kThreads, 0, stream>>>(locs, ok, centers, root, noise, rows_in, n,
                                                      rows_per_root, b, tol, trace_target,
                                                      trace_bound, subnormalized, rows_out, left);
}

}  // namespace

// coords: f32 rows of d² coordinates on the device, `row_stride` floats
// apart (unit column stride); basis: a host array of 2·d⁴ floats, the
// basis' real then imaginary parts, each (d², d, d); out: n bytes on the
// device. Returns cudaGetLastError() after the launch (nothing is launched
// for n = 0).
extern "C" int qt_psd_valid(const void* coords, int64_t n, int64_t row_stride, int dim,
                            const void* basis, float tol, float trace_target,
                            float trace_bound, int subnormalized, void* out, void* stream) {
  if (n < 0 || row_stride < 0 || (dim != 3 && dim != 4) || basis == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto* x = static_cast<const float*>(coords);
  const auto* b = static_cast<const float*>(basis);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    launch<3>(x, n, row_stride, b, tol, trace_target, trace_bound, subnormalized, o, st);
  } else {
    launch<4>(x, n, row_stride, b, tol, trace_target, trace_bound, subnormalized, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// locs, centers, noise: f32 (m, d²) on the device, rows back to back; ok:
// m bytes; root: f32 (m / rows_per_root, d², d²); rows_in: n row indices
// (int32) still invalid, or NULL for every row of the n = m that ok marks;
// basis as qt_psd_valid's; rows_out: room for n int32; left: one int on the
// device, set to 0, then the count of rows still invalid, which rows_out
// lists first (in no order). Returns the first error of the reset and the
// launch (nothing is launched for n = 0).
extern "C" int qt_psd_redraw(void* locs, void* ok, const void* centers, const void* root,
                             const void* noise, const void* rows_in, int64_t n,
                             int64_t rows_per_root, int dim, const void* basis, float tol,
                             float trace_target, float trace_bound, int subnormalized,
                             void* rows_out, void* left, void* stream) {
  if (n < 0 || (n > 0 && rows_per_root <= 0) || (dim != 3 && dim != 4) || basis == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t reset = cudaMemsetAsync(left, 0, sizeof(int), st);
  if (reset != cudaSuccess || n == 0) return static_cast<int>(reset);
  auto* l = static_cast<float*>(locs);
  auto* o = static_cast<uint8_t*>(ok);
  const auto* c = static_cast<const float*>(centers);
  const auto* r = static_cast<const float*>(root);
  const auto* e = static_cast<const float*>(noise);
  const auto* in = static_cast<const int*>(rows_in);
  const auto* b = static_cast<const float*>(basis);
  auto* out = static_cast<int*>(rows_out);
  auto* k = static_cast<int*>(left);
  if (dim == 3) {
    launch_redraw<3>(l, o, c, r, e, in, n, rows_per_root, b, tol, trace_target, trace_bound,
                     subnormalized, out, k, st);
  } else {
    launch_redraw<4>(l, o, c, r, e, in, n, rows_per_root, b, tol, trace_target, trace_bound,
                     subnormalized, out, k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
