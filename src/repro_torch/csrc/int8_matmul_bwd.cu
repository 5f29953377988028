// The int8 training backward of a W8A8 linear, for Hopper (sm_90a): the
// input gradient (nt) and the weight gradient (tn), each with the output
// gradient quantized to int8 inside the tile load.
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
// Bound: at the training shapes (M = 8192 tokens, K, N in {768, 3072}) both
// are bound by operations (2*M*N*K int8 ops at 1,979 TOP/s on the tensor
// cores); the bytes (M*N gradient values, K*N or M*K int8 payload) are a
// few MB.
//
// Design: the simple and exact version first, the same shape as the forward
// kernel (int8_matmul.cu): 64 x 64 output tiles, shared-memory tiles packed
// four int8 to a word along the contracted axis, __dp4a with int32 sums on
// the CUDA cores.  The TPU grid's sequential reduction axis (a VMEM
// accumulator across grid steps) becomes a loop inside the block; no
// split-K and no atomics, so the result is deterministic.  nt contracts N,
// the contiguous axis of both row-major operands, so its tiles load
// straight; tn contracts the token axis M, the leading axis of both, so its
// tile loads transpose into m-contiguous words.  The gradient is quantized
// as it enters shared memory -- the reference's fused quant prologue: h =
// g*fold, rint(h / qs) with an IEEE division (__fdiv_rn: nvcc never turns
// it into a reciprocal multiply) and round-half-to-even, so the payloads
// equal the plain version's and the JAX kernel's.  Each output block
// re-quantizes its gradient rows, as each TPU grid step does.  Tensor-core
// MMA (wgmma on K-major layouts), TMA and a one-pass gradient quantizer are
// later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t quant_g(float g, float fold, float qs) {
  float r = rintf(__fdiv_rn(__fmul_rn(g, fold), qs));
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// dx: output tile (16*TM rows of m) x (16*TK cols of k); contraction over n
// in steps of BN bytes.  g (M, N) carrier, w (K, N) int8, fold (N), qs (M).
template <int TM, int TK, int BN, typename GT, typename OutT>
__global__ void __launch_bounds__(kThreads)
nt_kernel(const GT* __restrict__ g, const int8_t* __restrict__ w,
          const float* __restrict__ fold, const float* __restrict__ qs,
          OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 16 * TM, BK = 16 * TK;
  constexpr int NW = BN / 4, NWP = NW + 1;  // padded stride: no conflicts
  __shared__ int32_t As[BM * NWP];          // [m][n] quantized gradient
  __shared__ int32_t Bs[BK * NWP];          // [k][n] weight payload
  __shared__ float rq[BM];                  // guarded qs of the tile's rows
  int8_t* Ab = reinterpret_cast<int8_t*>(As);
  int8_t* Bb = reinterpret_cast<int8_t*>(Bs);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  for (int r = tid; r < BM; r += kThreads)
    rq[r] = (m0 + r < M) ? scale_guard(qs[m0 + r]) : 1.0f;
  __syncthreads();

  int acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0;

  for (int n0 = 0; n0 < N; n0 += BN) {
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gm = m0 + r, gn = n0 + c;
      Ab[r * NWP * 4 + c] =
          (gm < M && gn < N)
              ? quant_g(to_f32(g[static_cast<size_t>(gm) * N + gn]), fold[gn],
                        rq[r])
              : 0;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bb[r * NWP * 4 + c] =
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int nw = 0; nw < NW; ++nw) {
      int a[TM], b[TK];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * NWP + nw];
#pragma unroll
      for (int j = 0; j < TK; ++j) b[j] = Bs[(tx + 16 * j) * NWP + nw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i, gm = m0 + r;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int gk = k0 + tx + 16 * j;
      if (gk >= K) continue;
      out[static_cast<size_t>(gm) * K + gk] =
          from_f32<OutT>(static_cast<float>(acc[i][j]) * rq[r]);
    }
  }
}

// dW: output tile (16*TK rows of k) x (16*TN cols of n); contraction over
// the tokens m in steps of BMS.  x (M, K) int8, g (M, N) carrier, fold (M),
// qs (N).
template <int TK, int TN, int BMS, typename GT, typename OutT>
__global__ void __launch_bounds__(kThreads)
tn_kernel(const int8_t* __restrict__ x, const GT* __restrict__ g,
          const float* __restrict__ fold, const float* __restrict__ qs,
          OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BK = 16 * TK, BN = 16 * TN;
  constexpr int MW = BMS / 4, MWP = MW + 1;
  __shared__ int32_t As[BK * MWP];          // [k][m] activation payload
  __shared__ int32_t Bs[BN * MWP];          // [n][m] quantized gradient
  __shared__ float cq[BN];                  // guarded qs of the tile's cols
  int8_t* Ab = reinterpret_cast<int8_t*>(As);
  int8_t* Bb = reinterpret_cast<int8_t*>(Bs);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.y * BK, n0 = blockIdx.x * BN;
  for (int c = tid; c < BN; c += kThreads)
    cq[c] = (n0 + c < N) ? scale_guard(qs[n0 + c]) : 1.0f;
  __syncthreads();

  int acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int m0 = 0; m0 < M; m0 += BMS) {
    // neighbouring threads read neighbouring k (or n) of one token row and
    // store them transposed, so four consecutive tokens form a word
    for (int e = tid; e < BMS * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      Ab[c * MWP * 4 + r] =
          (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
    }
    for (int e = tid; e < BMS * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gm = m0 + r, gn = n0 + c;
      Bb[c * MWP * 4 + r] =
          (gm < M && gn < N)
              ? quant_g(to_f32(g[static_cast<size_t>(gm) * N + gn]), fold[gm],
                        cq[c])
              : 0;
    }
    __syncthreads();
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      int a[TK], b[TN];
#pragma unroll
      for (int i = 0; i < TK; ++i) a[i] = As[(ty + 16 * i) * MWP + mw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[(tx + 16 * j) * MWP + mw];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int gk = k0 + ty + 16 * i;
    if (gk >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j, gn = n0 + c;
      if (gn >= N) continue;
      out[static_cast<size_t>(gk) * N + gn] =
          from_f32<OutT>(static_cast<float>(acc[i][j]) * cq[c]);
    }
  }
}

template <typename GT, typename OutT>
void launch_nt(const void* g, const void* w, const float* fold,
               const float* qs, void* out, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((K + 63) / 64, (M + 63) / 64);
  nt_kernel<4, 4, 32, GT, OutT><<<grid, kThreads, 0, s>>>(
      static_cast<const GT*>(g), static_cast<const int8_t*>(w), fold, qs,
      static_cast<OutT*>(out), M, N, K);
}

template <typename GT, typename OutT>
void launch_tn(const void* x, const void* g, const float* fold,
               const float* qs, void* out, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((N + 63) / 64, (K + 63) / 64);
  tn_kernel<4, 4, 32, GT, OutT><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const GT*>(g), fold, qs,
      static_cast<OutT*>(out), M, N, K);
}

// (gradient dtype, output dtype) -> one instantiation; false if unknown
template <template <typename, typename> class F, typename... Args>
bool dispatch2(int g_dtype, int out_dtype, Args... args) {
  if (g_dtype == kFloat32 && out_dtype == kFloat32)
    F<float, float>::run(args...);
  else if (g_dtype == kFloat32 && out_dtype == kBFloat16)
    F<float, __nv_bfloat16>::run(args...);
  else if (g_dtype == kBFloat16 && out_dtype == kFloat32)
    F<__nv_bfloat16, float>::run(args...);
  else if (g_dtype == kBFloat16 && out_dtype == kBFloat16)
    F<__nv_bfloat16, __nv_bfloat16>::run(args...);
  else
    return false;
  return true;
}

template <typename GT, typename OutT>
struct NT {
  static void run(const void* g, const void* w, const float* fold,
                  const float* qs, void* out, int M, int N, int K,
                  cudaStream_t s) {
    launch_nt<GT, OutT>(g, w, fold, qs, out, M, N, K, s);
  }
};

template <typename GT, typename OutT>
struct TN {
  static void run(const void* x, const void* g, const float* fold,
                  const float* qs, void* out, int M, int N, int K,
                  cudaStream_t s) {
    launch_tn<GT, OutT>(x, g, fold, qs, out, M, N, K, s);
  }
};

}  // namespace

// g (M, N) carrier, w (K, N) int8, fold (N) f32, qs (M) f32, all
// contiguous; out (M, K) in out_dtype (0 float32, 1 bfloat16).
extern "C" int repro_int8_matmul_nt(const void* g, const void* w,
                                    const void* fold, const void* qs,
                                    void* out, int M, int N, int K,
                                    int g_dtype, int out_dtype, void* stream) {
  if (!dispatch2<NT>(g_dtype, out_dtype, g, w,
                     static_cast<const float*>(fold),
                     static_cast<const float*>(qs), out, M, N, K,
                     static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) int8, g (M, N) carrier, fold (M) f32, qs (N) f32, all
// contiguous; out (K, N) in out_dtype.
extern "C" int repro_int8_matmul_tn(const void* x, const void* g,
                                    const void* fold, const void* qs,
                                    void* out, int M, int N, int K,
                                    int g_dtype, int out_dtype, void* stream) {
  if (!dispatch2<TN>(g_dtype, out_dtype, x, g,
                     static_cast<const float*>(fold),
                     static_cast<const float*>(qs), out, M, N, K,
                     static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
