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

template <int D>
__global__ void __launch_bounds__(kThreads)
psd_valid_rows(const float* __restrict__ coords, int64_t n, int64_t row_stride,
               const Basis<D> basis, float tol, float trace_target, float trace_bound,
               int subnormalized, uint8_t* __restrict__ out) {
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

  // ρ's lower triangle: ar on and below the diagonal, ai below it.
  float ar[D][D] = {}, ai[D][D] = {};
  const float x0 = tile[r * kPitch];
#pragma unroll
  for (int i = 0; i < kEl; ++i) {
    const float xi = i == 0 ? x0 : tile[r * kPitch + i];
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
  out[row0 + r] = (ok && trace_ok) ? 1 : 0;
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
