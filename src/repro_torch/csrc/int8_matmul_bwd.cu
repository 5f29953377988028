// The int8 training backward of a W8A8 linear, for Hopper (sm_90a): the
// input gradient (nt) and the weight gradient (tn), each with the output
// gradient quantized to int8 once and then multiplied on the int8 tensor
// cores.
//
// Replaces: src/repro/kernels/int8_matmul.py:int8_matmul_nt (its body is
// _int8_matmul_nt_kernel) and :int8_matmul_tn (_int8_matmul_tn_kernel):
//
//   nt  dx[m,k] = g(qs[m]) * sum_n clip(rint(g[m,n]*fold[n] / g(qs[m]))) * w[k,n]
//   tn  dW[k,n] = g(qs[n]) * sum_m x[m,k] * clip(rint(g[m,n]*fold[m] / g(qs[n])))
//
// with g mapping a 0 scale to 1, clip to [-128, 127], an exact int32 sum,
// then (float)sum * scale cast to the carrier.  fold is the other operand's
// dequant scale (the weight's per-channel scale for dx, the activation's
// per-token scale for dW) and qs the absmax / 127 of g*fold, reduced by the
// wrapper (kernels/ops.py), as in the reference.
//
// Bound: at the training shapes (M = 8192 tokens, K, N in {768, 3072}) the
// products (2*M*N*K int8 ops at 1,979 TOP/s) and the bytes (the gradient
// read once, an int8 payload, the output) are within 2x of each other:
// bytes at (768, 768), operations at the two others.  So the gradient is
// read once and the products run on the tensor cores.  Design:
//  1. Quantize once.  One memory-bound pass reads the gradient and writes
//     each payload once, K-major, rows padded to 16 bytes with zeros (TMA
//     strides; the wrapper allocates the buffers):
//       nt: gq (M, ldq), row-major -- its contraction axis N is contiguous;
//       tn: gqT (N, ldm) through a shared-memory tiled transpose, and the
//           activation payload x (M, K) into xT (K, ldm) the same way, both
//           in one launch.
//     wgmma takes 8-bit operands K-major only (the transpose bits exist for
//     16-bit types alone), and tn contracts the token axis M, the leading
//     axis of both row-major operands: hence its two transposes.  The
//     quantizer is the reference's: h = g*fold (__fmul_rn, never fused),
//     rint(h / qs) with an IEEE division (__fdiv_rn) and round-half-to-even.
//  2. One s8 tensor-core GEMM for both layouts (gemm_s8.cuh, shared with
//     the forward in int8_matmul.cu),
//       C[i, j] = cast(float(sum_k A[i, k] B[j, k]) * g(s)),
//     A (R, lda) and B (C, ldb) K-major int8, s per output row (nt: qs[m],
//     kRowScale) or per column (tn: qs[n], kColScale).  128 x 128 output
//     tiles in 128-byte contraction steps; a producer warp streams the A
//     and B tiles by TMA (128-byte swizzle; the hardware fills zeros past
//     every edge, so a ragged M, N or contraction needs no code) into a
//     3-stage mbarrier ring; two consumer warpgroups each run
//     wgmma m64n128k32.s32.s8.s8 into int32 registers, one group in flight
//     while the next is issued.  Two blocks share an SM, so one block's
//     epilogue (int32 -> fp32 round to nearest, one multiply by the guarded
//     scale, the cast, masked stores) runs under the other's products.
//  3. Split the contraction where the output tiles cannot fill the card
//     (tn at (768, 768): 36 tiles for 132 SMs).  Each split writes its
//     exact int32 partial tile to a workspace, and a second kernel adds the
//     splits in a fixed order and dequantizes once.  Integer addition is
//     associative, so every split count gives the same bits, run after run;
//     there are no atomics.  The split count comes from the shapes alone
//     (gemm_splits; the wrappers read it from the forward's library,
//     int8_matmul.cu:repro_int8_gemm_splits).
//  4. The two to three kernels of a call are programmatic dependent
//     launches: the card starts each while the one before it drains, and
//     each waits (griddepcontrol.wait) before it reads what that one wrote.
//  5. The MoE's experts (the reference's vmap over both kernels) run as
//     one call of E products of one shape: the quantize passes take a
//     grid dimension over the experts, each reading its own fold and
//     scales, and the GEMM's z runs over (expert, split) pairs
//     (gemm_s8.cuh).  tn contracts over an expert's C rows, which are
//     ragged (C = 2,049 at Granite's training shape): each expert's packed
//     rows are padded to 16 bytes with zeros on their own, so no stored
//     sum reads another expert's rows.  Expert e's bits are the 2-D call's.
// Tried and dropped, none faster at the training shapes on the H100:
// persistent GEMM blocks, 128 x 256 tiles (one block an SM), and letting the
// next kernel launch early (griddepcontrol.launch_dependents).
// Exactness: |sum| <= 128 * 128 * contraction, so the int32 sum (and every
// partial of it) is exact up to a contraction of 131,071 -- the limit of
// the reference's int32 accumulator; the entry points refuse more.  At M =
// 8192 the largest value is 1.3e8; (float)sum is exact below 2^24 and
// rounded to nearest once above, as the plain version's cast is.
#include "gemm_s8.cuh"

namespace {

constexpr int kQuantThreads = 256;
constexpr int kQuantRows = 4;  // rows per thread of nt's pass

// nt's pass: gq[m, n] = quant_g(g[m, n], fold[n], g(qs[m])) for n < N and
// 0 for N <= n < ldq.  A thread writes 8 bytes of each of kQuantRows rows
// of one expert, so its 8 fold values (that expert's) load once.  g, qs and
// gq hold `experts` blocks of M rows each, fold one row of N per expert;
// experts == 1 is the 2-D call.  vec (vec_fold): N % 8 == 0 and g (fold)
// 16-byte aligned, so each thread's 8 values load as whole vectors.
template <typename GT>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const GT* __restrict__ g, const float* __restrict__ fold,
                  const float* __restrict__ qs, int8_t* __restrict__ gq,
                  int M, int N, int ldq, int experts, bool vec,
                  bool vec_fold) {
  const int chunks = ldq / 8;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kQuantThreads +
                     threadIdx.x;
  const int groups = (M + kQuantRows - 1) / kQuantRows;  // an expert's
  if (idx >= static_cast<size_t>(groups) * experts * chunks) return;
  const int grp = static_cast<int>(idx / chunks);
  const int e = grp / groups;
  const int m0 = (grp % groups) * kQuantRows;
  const int n0 = static_cast<int>(idx % chunks) * 8;
  grid_dependency_wait();
  float f[8];
  load8(fold + static_cast<size_t>(e) * N, n0, N, vec_fold, f);
#pragma unroll
  for (int i = 0; i < kQuantRows; ++i) {
    if (m0 + i >= M) break;
    const size_t m = static_cast<size_t>(e) * M + m0 + i;
    float v[8];
    load8(g + m * N, n0, N, vec, v);
    const float rq = scale_guard(qs[m]);
    uint2 out;
    int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = n0 + k < N ? quant_g(v[k], f[k], rq) : 0;
    *reinterpret_cast<uint2*>(gq + m * ldq + n0) = out;
  }
}

// both of tn's passes in one launch: blocks with an even z quantize and
// transpose the gradient g (M, N) into gt, blocks with an odd z transpose x
// (M, K) into xt, each for expert z / 2: that expert's M rows of g, x and
// fold, its N scales qs, its (N, ldm) and (K, ldm) payloads.  An expert's
// payload rows are padded to ldm with zeros on their own, so no contraction
// reads another expert's rows.
template <typename GT>
__global__ void __launch_bounds__(256)
pack_tn_kernel(const GT* __restrict__ g, const int8_t* __restrict__ x,
               const float* __restrict__ fold, const float* __restrict__ qs,
               int8_t* __restrict__ gt, int8_t* __restrict__ xt, int M, int N,
               int K, int ldm, bool vec_g, bool vec_x) {
  __shared__ uint32_t tile[64][17];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  const size_t e = blockIdx.z / 2;
  if (blockIdx.z % 2 == 0) {
    if (c0 < N)
      pack_t_tile<GT, true>(g + e * M * N, fold + e * M, qs + e * N,
                            gt + e * N * ldm, M, N, ldm, vec_g, r0, c0, tile);
  } else if (c0 < K) {
    pack_t_tile<int8_t, false>(x + e * M * K, nullptr, nullptr,
                               xt + e * K * ldm, M, K, ldm, vec_x, r0, c0,
                               tile);
  }
}

// ----------------------------------------------------------------- host
// experts blocks of M rows (experts == 1: the 2-D pass)
int quant_rows(const void* g, const float* fold, const float* qs, void* gq,
               int M, int N, int g_dtype, cudaStream_t st, int experts = 1) {
  if (M < 1 || N < 1 || experts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldq = pad_to16(N);
  const bool vec = N % 8 == 0 && aligned16(g);
  const bool vec_fold = N % 8 == 0 && aligned16(fold);
  const size_t n = static_cast<size_t>(ceil_div(M, kQuantRows)) * experts *
                   (ldq / 8);
  const unsigned grid = static_cast<unsigned>((n + kQuantThreads - 1) /
                                              kQuantThreads);
  int8_t* o = static_cast<int8_t*>(gq);
  if (g_dtype == kFloat32)
    return launch_pdl(quant_rows_kernel<float>, dim3(grid),
                      dim3(kQuantThreads), 0, st,
                      static_cast<const float*>(g), fold, qs, o, M, N, ldq,
                      experts, vec, vec_fold);
  if (g_dtype == kBFloat16)
    return launch_pdl(quant_rows_kernel<__nv_bfloat16>, dim3(grid),
                      dim3(kQuantThreads), 0, st,
                      static_cast<const __nv_bfloat16*>(g), fold, qs, o, M,
                      N, ldq, experts, vec, vec_fold);
  return static_cast<int>(cudaErrorInvalidValue);
}

// both of tn's passes in one launch (pack_tn_kernel), for each of
// `experts` blocks of M rows
int pack_tn(const void* x, const void* g, const float* fold, const float* qs,
            void* xt, void* gt, int M, int N, int K, int g_dtype,
            cudaStream_t st, int experts = 1) {
  if (M < 1 || N < 1 || K < 1 || experts < 1 || 2L * experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ceil_div(N > K ? N : K, 64), ceil_div(M, 64), 2 * experts);
  const bool vec_g = N % 4 == 0 && aligned16(g);
  const bool vec_x = K % 4 == 0 && aligned16(x);
  const int8_t* xs = static_cast<const int8_t*>(x);
  int8_t* gto = static_cast<int8_t*>(gt);
  int8_t* xto = static_cast<int8_t*>(xt);
  if (g_dtype == kFloat32)
    return launch_pdl(pack_tn_kernel<float>, grid, dim3(256), 0, st,
                      static_cast<const float*>(g), xs, fold, qs, gto, xto, M,
                      N, K, pad_to16(M), vec_g, vec_x);
  if (g_dtype == kBFloat16)
    return launch_pdl(pack_tn_kernel<__nv_bfloat16>, grid, dim3(256), 0, st,
                      static_cast<const __nv_bfloat16*>(g), xs, fold, qs, gto,
                      xto, M, N, K, pad_to16(M), vec_g, vec_x);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ------------------------------------------------------------- the stages
// g (M, N) carrier, fold (N) f32, qs (M) f32 -> gq (M, pad16(N)) int8
extern "C" int repro_int8_quant_rows(const void* g, const void* fold,
                                     const void* qs, void* gq, int M, int N,
                                     int g_dtype, void* stream) {
  return quant_rows(g, static_cast<const float*>(fold),
                    static_cast<const float*>(qs), gq, M, N, g_dtype,
                    static_cast<cudaStream_t>(stream));
}

// tn's pass: x (M, K) int8 -> xT (K, pad16(M)) int8, and g (M, N) carrier,
// fold (M) f32, qs (N) f32 -> gqT (N, pad16(M)) int8
extern "C" int repro_int8_pack_tn(const void* x, const void* g,
                                  const void* fold, const void* qs, void* xt,
                                  void* gt, int M, int N, int K, int g_dtype,
                                  void* stream) {
  return pack_tn(x, g, static_cast<const float*>(fold),
                 static_cast<const float*>(qs), xt, gt, M, N, K, g_dtype,
                 static_cast<cudaStream_t>(stream));
}

// a (R, lda), b (C, ldb) int8 K-major (lda, ldb multiples of 16, 16-byte
// aligned), contraction Kc; scale per row (row_scale) or per column.
// splits == 1: out (R, C) in out_dtype; splits > 1: each split's int32
// partial sums into ws (splits, R, C), out and scale unused.
extern "C" int repro_int8_gemm(const void* a, const void* b, const void* scale,
                               void* out, void* ws, int R, int C, int Kc,
                               int lda, int ldb, int row_scale, int splits,
                               int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (splits > 1)
    return launch_gemm<kRowScale, float>(a, b, nullptr, nullptr, out, ws, R,
                                         C, Kc, lda, ldb, splits, st);
  return row_scale ? gemm_out<kRowScale>(out_dtype, a, b, s, nullptr, out, ws,
                                         R, C, Kc, lda, ldb, 1, st)
                   : gemm_out<kColScale>(out_dtype, a, b, nullptr, s, out, ws,
                                         R, C, Kc, lda, ldb, 1, st);
}

// ws (S, R, C) int32 -> out (R, C) = cast(float(sum over S) * g(scale))
extern "C" int repro_int8_split_reduce(const void* ws, const void* scale,
                                       void* out, int R, int C, int S,
                                       int row_scale, int out_dtype,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  return row_scale ? reduce_out<kRowScale>(out_dtype, ws, s, nullptr, out, R,
                                           C, S, st)
                   : reduce_out<kColScale>(out_dtype, ws, nullptr, s, out, R,
                                           C, S, st);
}

// ---------------------------------------------------- the two backwards
// g (M, N) carrier, w (K, ldw) int8 (ldw a multiple of 16, 16-byte
// aligned), fold (N) f32, qs (M) f32, all contiguous; gq (M, pad16(N)) and
// ws (splits, M, K) int32 (splits > 1 only) the wrapper's buffers; out (M,
// K) in out_dtype (0 float32, 1 bfloat16).
extern "C" int repro_int8_matmul_nt(const void* g, const void* w,
                                    const void* fold, const void* qs,
                                    void* out, void* gq, void* ws, int M,
                                    int N, int K, int ldw, int splits,
                                    int g_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qs);
  if (int e = quant_rows(g, static_cast<const float*>(fold), q, gq, M, N,
                         g_dtype, st))
    return e;
  return gemm_out<kRowScale>(out_dtype, gq, w, q, nullptr, out, ws, M, K, N,
                             pad_to16(N), ldw, splits, st);
}

// x (M, K) int8, g (M, N) carrier, fold (M) f32, qs (N) f32, all
// contiguous; xt (K, pad16(M)), gt (N, pad16(M)) and ws (splits, K, N)
// int32 (splits > 1 only) the wrapper's buffers; out (K, N) in out_dtype.
extern "C" int repro_int8_matmul_tn(const void* x, const void* g,
                                    const void* fold, const void* qs,
                                    void* out, void* xt, void* gt, void* ws,
                                    int M, int N, int K, int splits,
                                    int g_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qs);
  if (int e = pack_tn(x, g, static_cast<const float*>(fold), q, xt, gt, M, N,
                      K, g_dtype, st))
    return e;
  const int ldm = pad_to16(M);
  return gemm_out<kColScale>(out_dtype, xt, gt, nullptr, q, out, ws, K, N, M,
                             ldm, ldm, splits, st);
}

// ------------------------------------- the expert-batched backwards (MoE)
// E experts' products of one shape in one call (the reference's vmap over
// int8_matmul_nt and int8_matmul_tn): the quantize pass takes each expert's
// fold and scales, and the GEMM's z runs over (expert, split) pairs
// (gemm_s8.cuh).  Expert e's output is the 2-D call's on its slices, bit for
// bit.
//
// nt: g (E, M, N) carrier, w (E, K, ldw) int8, fold (E, N) f32, qs (E, M)
// f32, all contiguous; gq (E * M, pad16(N)) and ws (splits, E, M, K) int32
// (splits > 1 only) the wrapper's buffers; out (E, M, K) in out_dtype.
extern "C" int repro_int8_matmul_nt_experts(const void* g, const void* w,
                                            const void* fold, const void* qs,
                                            void* out, void* gq, void* ws,
                                            int M, int N, int K, int ldw,
                                            int splits, int experts,
                                            int g_dtype, int out_dtype,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qs);
  if (int e = quant_rows(g, static_cast<const float*>(fold), q, gq, M, N,
                         g_dtype, st, experts))
    return e;
  return gemm_out<kRowScale>(out_dtype, gq, w, q, nullptr, out, ws, M, K, N,
                             pad_to16(N), ldw, splits, st, experts);
}

// tn: x (E, M, K) int8, g (E, M, N) carrier, fold (E, M) f32, qs (E, N) f32,
// all contiguous; xt (E, K, pad16(M)), gt (E, N, pad16(M)) and ws (splits,
// E, K, N) int32 (splits > 1 only) the wrapper's buffers; out (E, K, N).
extern "C" int repro_int8_matmul_tn_experts(const void* x, const void* g,
                                            const void* fold, const void* qs,
                                            void* out, void* xt, void* gt,
                                            void* ws, int M, int N, int K,
                                            int splits, int experts,
                                            int g_dtype, int out_dtype,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qs);
  if (int e = pack_tn(x, g, static_cast<const float*>(fold), q, xt, gt, M, N,
                      K, g_dtype, st, experts))
    return e;
  const int ldm = pad_to16(M);
  return gemm_out<kColScale>(out_dtype, xt, gt, nullptr, q, out, ws, K, N, M,
                             ldm, ldm, splits, st, experts);
}
