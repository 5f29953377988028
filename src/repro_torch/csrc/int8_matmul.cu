// W8A8 int8 matmul with the rank-1 dequant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py:int8_matmul (its body is
// _int8_matmul_kernel): y[m,n] = ((float)sum_k x[m,k]*w[k,n]) * g(rs[m]) *
// g(cs[n]), an int32 sum, g mapping a 0 scale to 1, the two products rounded
// in that order, cast to the carrier -- bit for bit ref.int8_matmul_ref.
//
// Bound: a serving linear at decode (M = 16 slots) reads the whole int8
// weight once for a few MACs per byte, so it is bound by bytes (K*N at
// 3.35 TB/s); at prefill and in training (M in the thousands) by operations
// (2*M*N*K at 1,979 int8 TOP/s on the tensor cores) or, at (768, 768), by
// the bytes of x and y.
//
// Two routes, chosen by the wrapper (kernels/int8_matmul.py:fwd_route),
// both kernels:
//  - M > 16, repro_int8_matmul_wgmma: the int8 tensor cores.  wgmma takes
//    8-bit operands K-major only (the transpose bits exist for 16-bit types
//    alone), and y = x.w contracts w's leading axis, so one tiled transpose
//    pass per call writes wT (N, pad16(K)) (transpose_kernel, 64 x 64 tiles
//    through shared memory, zeros past K); x (M, K) is already K-major (the
//    wrapper pads a copy only where K is no multiple of 16 bytes or x is off
//    a 16-byte boundary).  Then gemm_s8.cuh's GEMM (TMA ring, s8 wgmma,
//    128 x 128 tiles, two blocks an SM) with both scales in its epilogue,
//    ((float)acc * g(rs)) * g(cs), split over the contraction with exact
//    int32 partials and a fixed-order reduction where its tiles cannot fill
//    the card (the split count from the shapes, repro_int8_gemm_splits).
//    The two or three kernels of a call chain by programmatic dependent
//    launch; the wrapper counts the call as one launch.
//  - M <= 16 (the decode step), repro_int8_matmul_dp4a: the simple and
//    exact CUDA-core kernel the port began with.  Shared-memory tiles,
//    int32 accumulation with __dp4a, the JAX layout at the interface (the
//    tile load transposes w into k-contiguous words); 16 x 16 outputs with a
//    128-byte k step (many blocks, few k steps).  A decode call is a
//    weight-streaming problem whose launch is short next to the host's
//    dispatch (the decode step's idle share is 0.78-0.88); a split-K
//    weight stream comes after CUDA graphs.  The entry also takes M > 16
//    with 64 x 64 tiles and a 32-byte k step (the port's first forward at
//    every M, kept as the yardstick the wgmma route is timed against).
// Both routes: edges masked, any M, N, K (K up to 131,071 on the tensor
// cores: |sum| <= 128 * 128 * K < 2^31).
#include "gemm_s8.cuh"

namespace {

// ------------------------------------------------------------ dp4a route
template <int TM, int TN, int BK, typename OutT>
__global__ void __launch_bounds__(256)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ rs, const float* __restrict__ cs,
                   OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int KW = BK / 4;        // int32 words per tile row
  constexpr int KWP = KW + 1;       // padded stride: conflict-free columns
  __shared__ int32_t As[BM * KWP];  // [m][k] packed by 4
  __shared__ int32_t Bs[BN * KWP];  // [n][k] packed by 4 (transposed)
  int8_t* Ab = reinterpret_cast<int8_t*>(As);
  int8_t* Bb = reinterpret_cast<int8_t*>(Bs);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: neighbouring threads read neighbouring k bytes of one row
    for (int e = tid; e < BM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      Ab[r * KWP * 4 + c] =
          (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
    }
    // B tile: neighbouring threads read neighbouring n bytes of one k row,
    // stored transposed so four consecutive k of one column form a word
    for (int e = tid; e < BK * BN; e += 256) {
      const int c = e % BN, r = e / BN;
      const int gk = k0 + r, gn = n0 + c;
      Bb[c * KWP * 4 + r] =
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * KWP + kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[(tx + 16 * j) * KWP + kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float r = scale_guard(rs[gm]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float v = (static_cast<float>(acc[i][j]) * r) * scale_guard(cs[gn]);
      out[static_cast<size_t>(gm) * N + gn] = from_f32<OutT>(v);
    }
  }
}

template <int TM, int TN, int BK, typename OutT>
void launch_dp4a(const int8_t* x, const int8_t* w, const float* rs,
                 const float* cs, OutT* out, int M, int N, int K,
                 cudaStream_t stream) {
  dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  int8_matmul_kernel<TM, TN, BK, OutT><<<grid, 256, 0, stream>>>(
      x, w, rs, cs, out, M, N, K);
}

template <typename OutT>
void dispatch_dp4a(const int8_t* x, const int8_t* w, const float* rs,
                   const float* cs, OutT* out, int M, int N, int K,
                   cudaStream_t stream) {
  if (M <= 16)
    launch_dp4a<1, 1, 128>(x, w, rs, cs, out, M, N, K, stream);
  else
    launch_dp4a<4, 4, 32>(x, w, rs, cs, out, M, N, K, stream);
}

// ----------------------------------------------------------- wgmma route
// src (R, Cn) int8 -> dst (Cn, pad16(R)), zeros past R: one 64 x 64 tile a
// block (gemm_s8.cuh:pack_t_tile)
__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                 int R, int Cn, int ldd, bool vec) {
  __shared__ uint32_t tile[64][17];
  pack_t_tile<int8_t, false>(src, nullptr, nullptr, dst, R, Cn, ldd, vec,
                             blockIdx.y * 64, blockIdx.x * 64, tile);
}

int transpose(const void* src, void* dst, int R, int Cn, cudaStream_t st) {
  if (R < 1 || Cn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Cn % 4 == 0 && aligned16(src);
  return launch_pdl(transpose_kernel, dim3(ceil_div(Cn, 64), ceil_div(R, 64)),
                    dim3(256), 0, st, static_cast<const int8_t*>(src),
                    static_cast<int8_t*>(dst), R, Cn, pad_to16(R), vec);
}

}  // namespace

// ------------------------------------------------------------- the routes
// x (M, K) int8, w (K, N) int8, rs (M) f32, cs (N) f32, all contiguous;
// out (M, N) in the carrier (out_dtype: 0 float32, 1 bfloat16).  The
// CUDA-core kernel at any M (16 x 16 tiles at M <= 16, 64 x 64 above).
extern "C" int repro_int8_matmul_dp4a(const void* x, const void* w,
                                      const void* rs, const void* cs,
                                      void* out, int M, int N, int K,
                                      int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto rp = static_cast<const float*>(rs);
  auto cp = static_cast<const float*>(cs);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == kFloat32)
    dispatch_dp4a(xp, wp, rp, cp, static_cast<float*>(out), M, N, K, s);
  else if (out_dtype == kBFloat16)
    dispatch_dp4a(xp, wp, rp, cp, static_cast<__nv_bfloat16*>(out), M, N, K,
                  s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: x (M, ldx) int8 K-major (ldx a multiple of 16,
// 16-byte aligned, the first K bytes of a row the payload), w (K, N) int8
// contiguous, rs (M) and cs (N) f32; wt (N, pad16(K)) int8 and ws (splits,
// M, N) int32 (splits > 1 only) the wrapper's buffers; out (M, N) in
// out_dtype.  The transpose pass, the GEMM, and the split reduction where
// it splits.
extern "C" int repro_int8_matmul_wgmma(const void* x, const void* w,
                                       const void* rs, const void* cs,
                                       void* out, void* wt, void* ws, int M,
                                       int N, int K, int ldx, int splits,
                                       int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = transpose(w, wt, K, N, st)) return e;
  return gemm_out<kBothScales>(out_dtype, x, wt,
                               static_cast<const float*>(rs),
                               static_cast<const float*>(cs), out, ws, M, N,
                               K, ldx, pad_to16(K), splits, st);
}

// ------------------------------------------------------------- the stages
// src (R, Cn) int8 contiguous -> dst (Cn, pad16(R)) int8, zeros past R
extern "C" int repro_int8_transpose(const void* src, void* dst, int R, int Cn,
                                    void* stream) {
  return transpose(src, dst, R, Cn, static_cast<cudaStream_t>(stream));
}

// a (R, lda), b (C, ldb) int8 K-major (lda, ldb multiples of 16, 16-byte
// aligned), contraction Kc, rs (R) and cs (C) f32.  splits == 1: out (R, C)
// = cast((float(sum) * g(rs)) * g(cs)) in out_dtype; splits > 1: each
// split's int32 partial sums into ws (splits, R, C), out and the scales
// unused.
extern "C" int repro_int8_gemm_fwd(const void* a, const void* b,
                                   const void* rs, const void* cs, void* out,
                                   void* ws, int R, int C, int Kc, int lda,
                                   int ldb, int splits, int out_dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1)
    return launch_gemm<kBothScales, float>(a, b, nullptr, nullptr, out, ws, R,
                                           C, Kc, lda, ldb, splits, st);
  return gemm_out<kBothScales>(out_dtype, a, b, static_cast<const float*>(rs),
                               static_cast<const float*>(cs), out, nullptr, R,
                               C, Kc, lda, ldb, 1, st);
}

// ws (S, R, C) int32 -> out (R, C) = cast((float(sum over S) * g(rs)) *
// g(cs))
extern "C" int repro_int8_split_reduce_fwd(const void* ws, const void* rs,
                                           const void* cs, void* out, int R,
                                           int C, int S, int out_dtype,
                                           void* stream) {
  return reduce_out<kBothScales>(out_dtype, ws, static_cast<const float*>(rs),
                                 static_cast<const float*>(cs), out, R, C, S,
                                 static_cast<cudaStream_t>(stream));
}

// the split count the tensor-core route expects for an (R, C) output over a
// contraction of Kc (the wrapper sizes the workspace by it)
extern "C" int repro_int8_gemm_splits(int R, int C, int Kc) {
  return gemm_splits(R, C, Kc);
}
