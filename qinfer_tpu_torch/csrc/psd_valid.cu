// The validity test of d-level tomography (d = 3, 4, 8) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package tests positivity with the
// characteristic polynomial of the real embedding in plain jnp
// (qinfer_tpu/tomography/models.py:_psd_via_charpoly), which XLA fuses. The
// port's test (ops/psd_valid.py:psd_valid_plain) builds ρ from the
// coordinates with two matrix products and factors ρ + psd_tol·I by LDLᴴ in
// d − 1 rank-one Schur steps of about sixteen elementwise launches each:
// 35–57 launches and their host time a test at d = 3, 4, 7 steps at d = 8,
// and a Liu–West resample under postselection tests its whole bank ≈ 14
// times. This kernel is the same test in one launch. For each row of
// coordinates x (d² f32 values, row stride `row_stride`) it writes one byte:
//     ok = [every pivot of LDLᴴ(ρ + tol·I) > 0] ∧ [trace test on x₀]
// with ρ = Σ_i x_i B_i, the trace test |x₀ − 1/√d| < 1e-4, or x₀ ≤ 1/√d +
// 1e-5 for subnormalised states (the two thresholds come rounded to f32
// from the wrapper, as torch rounds them).
//
// What bounds it on this card. d = 3, 4: memory. A row is read once, 4·d²
// bytes, and one byte is written: 68.2 MB at 2^20 rows and d = 4, ≈ 20.3
// µs at 3.35 TB/s. The arithmetic is 2·d⁴ products for ρ (512 at d = 4)
// and a 4 × 4 factorization, ≈ 0.6 GFLOP at 2^20 rows, ≈ 9 µs at the f32
// rate. d = 8 in a dense basis (Gell-Mann): arithmetic. ρ's triangle is
// 2·d⁴ = 8192 flops a row against 257 bytes, 32 flop/B, above the card's
// f32 ridge (≈ 20: 67 TFLOP/s over 3.35 TB/s): at 2^19 rows (the
// three-qubit bank) ≈ 68 µs of operations against 40 µs of bytes. d = 8 in
// the product-Pauli basis of the three-qubit model: memory. Its elements
// are monomial (one nonzero a row), so ρ's triangle takes 288 of the 4096
// products (≈ 9 µs of operations at 2^19 rows) and the bound is the 40 µs
// of bytes; the kernel builds ρ densely for every basis.
//
// Design. A block stages its rows through shared memory: thread t loads
// the block's flat element t, t + blockDim, …, so neighbouring lanes read
// neighbouring words, coalesced at any row stride (the view
// modelparams[:, :-1] of the diffusive model has stride d² + 1), into rows
// of an odd pitch, so that a warp reading its 32 rows hits 32 banks; rows
// that lie back to back (unit row stride) are read as one contiguous span.
// Then one thread a row. ρ's lower triangle is built in registers (the
// real part on and below the diagonal, the imaginary part below it: all
// that the factorization reads), each entry a sum over the d² coordinates
// in order; the coordinates are the outer loop, so each is read from the
// tile once while the sums stay in registers.
//
// d = 3, 4: 256 rows a block. The basis is a kernel parameter (2·d⁴
// floats: 2 KB at d = 4) and every loop is unrolled, so each coefficient
// is an operand from the constant bank and not a load. With the sums as
// the outer loop ptxas kept 32 registers and the kernel took 56.6 µs at
// 2^20 rows, d = 4, on an H100; this order takes 40 registers and 40.6 µs
// (17.8 µs at d = 3, against 11.6).
//
// d = 8: the full basis (2·d⁴ floats, 32768 B) exceeds the 32764 bytes a
// kernel's parameters may hold, so the parameter is what the test reads of
// each element, its lower triangle (Triangle: d² floats an element, 16 KB).
// Unrolled as at d = 3, 4 the test is ≈ 7k instructions and the round
// ≈ 16k: at 2^19 rows the test took 343 µs, the round over 477 297 rows
// 1284 µs (198 registers; the masked chain on that test 784). So the loop
// over the coordinates is rolled, and the 64 entries of an element are
// read as 16 float4 broadcasts. The test stages the Triangle in shared memory beside
// 96 rows (41 KB; 127 registers): 267 µs at 2^19 rows, H100, against 311
// with 128 rows reading the parameter, 364 with 64, 343 unrolled. The
// remaining gap to a dense basis' 68 µs is the broadcasts, 16 loads of 16
// bytes for every 64 FMAs; to the product-Pauli basis' 40 µs, the dense
// build itself.
//
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
// same device code, and where x is a state writes it and its byte of ok,
// else lists i and counts it in `left`, the round's one host read. It
// replaces the masked chain (the GEMM ε·Sᵀ, its add, the test of the whole
// bank, ~ok, &, where, |: ≈ 270 µs at 2^20 rows, d = 4; ≈ 4.7 ms at 2^19,
// d = 8, on the plain test) and its eight launches.
//
// What bounds it: the rows still invalid, each a gather of its 2·d² noise
// and center floats and a scatter of its row or its index, with d⁴
// products for the smear and the test's 2·d⁴ + d³ on top (≈ 1.3k flops a
// row at d = 4, ≈ 17k at d = 8). At d = 4 the roofline is tiny (≈ 0.8 µs
// at 2^14 rows); the launch and the load of a partly filled grid bound it:
// 7.4 µs with 20 rows left, 11.9 µs with 2^14, 95 µs with 2^19 (d = 4,
// 2^20 rows, H100). At d = 8 one row's serial work bounds a small round:
// 51 µs with 20 rows left, 59 with 2^14, 398 with 2^18, 642 with 477 297
// (2^19 rows, H100; the masked chain 4.7 ms).
//
// Layout. One thread a row: the row's noise and center from global memory
// (L1 serves a row's bytes to its thread), S's d⁴ floats by __ldg (the same
// address across a warp whose rows share a bank: one broadcast), the smear
// in registers as one FMA chain over the columns in order from 0, then the
// center added, which is how cuBLAS rounds the GEMM and torch the add on
// all but a few rows in 10^5 (0.25 ulp of the row's scale at most). At
// d = 8 the noise and S are read as float4, the smear runs row by row of
// S (unrolled by 4: 168 registers, 128 rows a block), each x_a kept in
// the thread's row of a shared tile (33 KB) and summed into ρ's triangle
// at once from the parameter; staging the Triangle beside 96 rows instead
// took 950 µs over 477 297 rows, unrolling by 8 1343.
// The first round walks the mask (every row, those valid return at once);
// it and each later round list the rows left by atomicAdd on `left`, and a
// later round walks only that list. Measured at 2^20 rows, d = 4, with 2^14
// rows left scattered through the bank, each form timed first and then
// second in one run: the mask walk takes 33.5 µs (a warp holds half a row
// to test, and idles the rest of its lanes), the list 11.9 µs (d = 3: 15.4
// against 7.9); with 20 left 9.2 against 7.4; with half the bank left
// 106.7 against 95.4 (d = 8, 2^19 rows: 346 against 59 with 2^14 left,
// 614 against 398 with 2^18). So the first round, where only the mask
// exists, walks it, and every later one the list. 48 registers at d = 4,
// 32 at d = 3.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// d = 3, 4: the basis' real and imaginary parts, [element][a·d + b], as
// TomographyBasis.re_im holds them (2·d⁴ floats).
template <int D>
struct Basis {
  float re[D * D][D * D];
  float im[D * D][D * D];
};

// d = 8: what the test reads of each element, ρ's lower triangle,
// [element][entry]: the real part on and below the diagonal row by row
// (d(d+1)/2 entries, entry re_entry(a, b)), then the imaginary part below
// it (d(d−1)/2, im_entry(a, b)); d² floats an element, d⁴ in all (16 KB),
// where the full parts (32768 B) exceed the 32764 bytes that a kernel's
// parameters may hold. The launch packs it from the host's Basis layout.
template <int D>
struct alignas(16) Triangle {
  float c[D * D][D * D];
};

__host__ __device__ constexpr int re_entry(int a, int b) { return a * (a + 1) / 2 + b; }
template <int D>
__host__ __device__ constexpr int im_entry(int a, int b) {
  return D * (D + 1) / 2 + a * (a - 1) / 2 + b;
}

// The d whose kernels take the Triangle and roll their loops over the
// coordinates (the head of the file).
template <int D>
constexpr bool kRolled = D >= 8;

template <int D>
using BasisArg = typename std::conditional<kRolled<D>, Triangle<D>, Basis<D>>::type;

// Rows (one a thread) a block of the test and of the round: 256 at d = 3,
// 4; at d = 8 the test's 96 rows at pitch d² + 1 and the Triangle take 41
// KB of static shared memory, the round's 128 rows 33 KB. The rolled
// loops' unroll factors: 2 in the test, 4 in the round.
template <int D>
constexpr int kTestRows = kRolled<D> ? 96 : kThreads;
template <int D>
constexpr int kRoundRows = kRolled<D> ? 128 : kThreads;
constexpr int kTestUnroll = 2;
constexpr int kRoundUnroll = 4;

// The test on ρ's lower triangle (ar on and below the diagonal, ai below
// it) of a row whose first coordinate is x0:
// ok = [every pivot of LDLᴴ(ρ + tol·I) > 0] ∧ [trace test on x₀].
template <int D>
__device__ __forceinline__ bool ldl_trace_test(float (&ar)[D][D], float (&ai)[D][D], float x0,
                                               float tol, float trace_target, float trace_bound,
                                               int subnormalized) {
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

// d = 3, 4: the test of one row x (d² coordinates) in registers or shared
// memory, ρ's entries summed with the basis as constant operands.
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
  return ldl_trace_test<D>(ar, ai, x0, tol, trace_target, trace_bound, subnormalized);
}

// d = 8: t (ρ's lower triangle, the Triangle order) += xi · element i of
// `c` (16-byte aligned: constant bank or shared memory), one FMA an entry.
template <int D>
__device__ __forceinline__ void add_element(float (&t)[D * D], float xi, const float* c) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
#pragma unroll
  for (int q = 0; q < D * D / 4; ++q) {
    const float4 v = c4[q];
    t[4 * q] = fmaf(xi, v.x, t[4 * q]);
    t[4 * q + 1] = fmaf(xi, v.y, t[4 * q + 1]);
    t[4 * q + 2] = fmaf(xi, v.z, t[4 * q + 2]);
    t[4 * q + 3] = fmaf(xi, v.w, t[4 * q + 3]);
  }
}

// d = 8: the test on the triangle t of a row whose first coordinate is x0.
template <int D>
__device__ __forceinline__ bool is_state_triangle(const float (&t)[D * D], float x0, float tol,
                                                  float trace_target, float trace_bound,
                                                  int subnormalized) {
  float ar[D][D], ai[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      ar[a][b] = t[re_entry(a, b)];
      if (a != b) ai[a][b] = t[im_entry<D>(a, b)];
    }
  }
  return ldl_trace_test<D>(ar, ai, x0, tol, trace_target, trace_bound, subnormalized);
}

// d = 8: the test of one row x in shared memory, the Triangle `coef`
// staged in shared memory (the loop over the coordinates rolled).
template <int D>
__device__ __forceinline__ bool is_state(const float* x, const float* coef, float tol,
                                         float trace_target, float trace_bound,
                                         int subnormalized) {
  constexpr int kEl = D * D;
  float t[kEl] = {};
#pragma unroll kTestUnroll
  for (int i = 0; i < kEl; ++i) add_element<D>(t, x[i], coef + i * kEl);
  return is_state_triangle<D>(t, x[0], tol, trace_target, trace_bound, subnormalized);
}

template <int D>
__global__ void __launch_bounds__(kTestRows<D>)
psd_valid_rows(const float* __restrict__ coords, int64_t n, int64_t row_stride,
               const __grid_constant__ BasisArg<D> basis, float tol, float trace_target,
               float trace_bound, int subnormalized, uint8_t* __restrict__ out) {
  constexpr int kEl = D * D;
  constexpr int kPitch = kEl | 1;  // odd: a warp's 32 rows on 32 banks
  constexpr int kRows = kTestRows<D>;
  __shared__ float tile[kRows * kPitch];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  if (row_stride == kEl) {  // the block's rows are one contiguous span
    const float* span = coords + row0 * kEl;
#pragma unroll
    for (int it = 0; it < kEl; ++it) {
      const int k = it * kRows + threadIdx.x;
      if (k < rows * kEl) tile[(k / kEl) * kPitch + k % kEl] = __ldg(span + k);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kEl; ++it) {
      const int k = it * kRows + threadIdx.x;
      const int r = k / kEl;
      if (r < rows) tile[r * kPitch + k % kEl] = __ldg(coords + (row0 + r) * row_stride + k % kEl);
    }
  }
  // d = 8: the Triangle staged beside the rows (a warp's lanes read one
  // coefficient at a time, a broadcast). Declared here: staged by a helper
  // that returned a pointer to it, the test took 376 µs at 2^19 rows
  // against 267 (H100), with the same registers and shared memory.
  __shared__ float4 coef[kRolled<D> ? kEl * kEl / 4 : 1];
  if constexpr (kRolled<D>) {
    for (int k = threadIdx.x; k < kEl * kEl / 4; k += kRows) {
      coef[k] = reinterpret_cast<const float4*>(&basis.c[0][0])[k];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* x = tile + r * kPitch;
  bool state;
  if constexpr (kRolled<D>) {
    state = is_state<D>(x, reinterpret_cast<const float*>(coef), tol, trace_target,
                        trace_bound, subnormalized);
  } else {
    state = is_state<D>(x, basis, tol, trace_target, trace_bound, subnormalized);
  }
  out[row0 + r] = state ? 1 : 0;
}

// One redraw round of postselection on the rows still invalid: row i of
// the list `rows_in` (n of them), or with no list every row of the n that
// `ok` marks invalid. x = centers[i] + S·ε[i] with S the root of row i's
// bank (the bank of rows_per_root rows that holds i), the same test, and
// where x is a state, locs[i] = x and ok[i] = 1; else i goes to
// rows_out[atomicAdd(left, 1)], so `left` counts the rows still invalid.
template <int D>
__global__ void __launch_bounds__(kRoundRows<D>)
psd_redraw_rows(float* __restrict__ locs, uint8_t* __restrict__ ok,
                const float* __restrict__ centers, const float* __restrict__ root,
                const float* __restrict__ noise, const int* __restrict__ rows_in, int64_t n,
                int64_t rows_per_root, const __grid_constant__ BasisArg<D> basis, float tol,
                float trace_target, float trace_bound, int subnormalized,
                int* __restrict__ rows_out, int* __restrict__ left) {
  constexpr int kEl = D * D;
  constexpr int kRows = kRoundRows<D>;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  if (k >= n) return;
  const int64_t i = rows_in != nullptr ? rows_in[k] : k;
  if (rows_in == nullptr && ok[i]) return;
  const float* s = root + (i / rows_per_root) * (kEl * kEl);
  float* x;  // the smeared row: in registers at d = 3, 4, a tile's row at d = 8
  float row[kEl];
  bool state;
  if constexpr (kRolled<D>) {
    // The smear row by row of S (float4 loads: the wrapper aligns S and ε
    // to 16 bytes), each x_a kept in the thread's row of a tile and summed
    // into ρ's triangle at once, the Triangle read from the parameter.
    constexpr int kPitch = kEl | 1;
    __shared__ float tile[kRows * kPitch];
    x = tile + threadIdx.x * kPitch;
    float eps[kEl], t[kEl] = {};
    const float4* e4 = reinterpret_cast<const float4*>(noise + i * kEl);
#pragma unroll
    for (int q = 0; q < kEl / 4; ++q) {
      const float4 v = __ldg(e4 + q);
      eps[4 * q] = v.x;
      eps[4 * q + 1] = v.y;
      eps[4 * q + 2] = v.z;
      eps[4 * q + 3] = v.w;
    }
#pragma unroll kRoundUnroll
    for (int a = 0; a < kEl; ++a) {
      const float4* s4 = reinterpret_cast<const float4*>(s + a * kEl);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kEl / 4; ++q) {
        const float4 v = __ldg(s4 + q);
        acc = fmaf(eps[4 * q], v.x, acc);
        acc = fmaf(eps[4 * q + 1], v.y, acc);
        acc = fmaf(eps[4 * q + 2], v.z, acc);
        acc = fmaf(eps[4 * q + 3], v.w, acc);
      }
      const float xa = __fadd_rn(__ldg(centers + i * kEl + a), acc);
      x[a] = xa;
      add_element<D>(t, xa, basis.c[a]);
    }
    state = is_state_triangle<D>(t, x[0], tol, trace_target, trace_bound, subnormalized);
  } else {
    x = row;
    float eps[kEl];
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
    state = is_state<D>(x, basis, tol, trace_target, trace_bound, subnormalized);
  }
  if (state) {
#pragma unroll(kRolled<D> ? kRoundUnroll : kEl)
    for (int a = 0; a < kEl; ++a) locs[i * kEl + a] = x[a];
    ok[i] = 1;
  } else {
    rows_out[atomicAdd(left, 1)] = static_cast<int>(i);
  }
}

// The kernels' parameter from the host's basis (2·d⁴ floats, Basis's
// layout): at d = 3, 4 as it is, at d = 8 each element's lower triangle.
template <int D>
void pack(Basis<D>& to, const float* basis) {
  memcpy(&to, basis, sizeof(to));
}

template <int D>
void pack(Triangle<D>& to, const float* basis) {
  constexpr int kEl = D * D;
  for (int i = 0; i < kEl; ++i) {
    const float* re = basis + i * kEl;
    const float* im = basis + (kEl + i) * kEl;
    for (int a = 0; a < D; ++a) {
      for (int b = 0; b <= a; ++b) {
        to.c[i][re_entry(a, b)] = re[a * D + b];
        if (a != b) to.c[i][im_entry<D>(a, b)] = im[a * D + b];
      }
    }
  }
}

template <int D>
void launch(const float* coords, int64_t n, int64_t row_stride, const float* basis, float tol,
            float trace_target, float trace_bound, int subnormalized, uint8_t* out,
            cudaStream_t stream) {
  BasisArg<D> b;
  pack<D>(b, basis);
  constexpr int rows = kTestRows<D>;
  const auto blocks = static_cast<unsigned>((n + rows - 1) / rows);
  psd_valid_rows<D><<<blocks, rows, 0, stream>>>(coords, n, row_stride, b, tol, trace_target,
                                                 trace_bound, subnormalized, out);
}

template <int D>
void launch_redraw(float* locs, uint8_t* ok, const float* centers, const float* root,
                   const float* noise, const int* rows_in, int64_t n, int64_t rows_per_root,
                   const float* basis, float tol, float trace_target, float trace_bound,
                   int subnormalized, int* rows_out, int* left, cudaStream_t stream) {
  BasisArg<D> b;
  pack<D>(b, basis);
  constexpr int rows = kRoundRows<D>;
  const auto blocks = static_cast<unsigned>((n + rows - 1) / rows);
  psd_redraw_rows<D><<<blocks, rows, 0, stream>>>(locs, ok, centers, root, noise, rows_in, n,
                                                  rows_per_root, b, tol, trace_target,
                                                  trace_bound, subnormalized, rows_out, left);
}

// The d that the kernels are built for.
bool kernel_dim(int dim) { return dim == 3 || dim == 4 || dim == 8; }

}  // namespace

// coords: f32 rows of d² coordinates on the device, `row_stride` floats
// apart (unit column stride); dim: 3, 4 or 8; basis: a host array of
// 2·d⁴ floats, the basis' real then imaginary parts, each (d², d, d); out: n bytes on the device. Returns cudaGetLastError() after the launch
// (nothing is launched for n = 0).
extern "C" int qt_psd_valid(const void* coords, int64_t n, int64_t row_stride, int dim,
                            const void* basis, float tol, float trace_target,
                            float trace_bound, int subnormalized, void* out, void* stream) {
  if (n < 0 || row_stride < 0 || !kernel_dim(dim) || basis == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto* x = static_cast<const float*>(coords);
  const auto* b = static_cast<const float*>(basis);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    launch<3>(x, n, row_stride, b, tol, trace_target, trace_bound, subnormalized, o, st);
  } else if (dim == 4) {
    launch<4>(x, n, row_stride, b, tol, trace_target, trace_bound, subnormalized, o, st);
  } else {
    launch<8>(x, n, row_stride, b, tol, trace_target, trace_bound, subnormalized, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// locs, centers, noise: f32 (m, d²) on the device, rows back to back; ok:
// m bytes; root: f32 (m / rows_per_root, d², d²) (at d = 8 noise and root
// 16-byte aligned); rows_in: n row indices
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
  if (n < 0 || (n > 0 && rows_per_root <= 0) || !kernel_dim(dim) || basis == nullptr) {
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
  } else if (dim == 4) {
    launch_redraw<4>(l, o, c, r, e, in, n, rows_per_root, b, tol, trace_target, trace_bound,
                     subnormalized, out, k, st);
  } else {
    launch_redraw<8>(l, o, c, r, e, in, n, rows_per_root, b, tol, trace_target, trace_bound,
                     subnormalized, out, k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
