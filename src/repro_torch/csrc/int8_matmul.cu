// W8A8 int8 matmul with the rank-1 dequant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py:int8_matmul (its body is
// _int8_matmul_kernel): y[m,n] = ((float)sum_k x[m,k]*w[k,n]) * g(rs[m]) *
// g(cs[n]), an int32 sum, g mapping a 0 scale to 1, cast to the carrier.
//
// Bound: a serving linear at decode (M = 16 slots) reads the whole int8
// weight once for a few MACs per byte, so it is bound by bytes (K*N at
// 3.35 TB/s); at prefill (M in the thousands) it is bound by operations
// (2*M*N*K at 1,979 int8 TOP/s on the tensor cores).
//
// Design: the simple and exact version first.  Shared-memory tiles, int32
// accumulation with __dp4a (four int8 MACs per instruction on the CUDA
// cores, not the tensor cores), the JAX layout at the interface (w is
// (K, N) row-major; the tile load transposes it into k-contiguous words).
// Two tile shapes: 16 x 16 outputs with a 128-byte k step for decode
// (M <= 16: many blocks, few k steps) and 64 x 64 with a 32-byte k step
// otherwise.  Edges are masked, so any M, N, K works.  The epilogue
// multiplies in the reference's order, ((float)acc * g(rs)) * g(cs), so
// the result equals ref.int8_matmul_ref bit for bit.  Tensor-core MMA
// (wgmma on a K-major weight layout), TMA and split-K are later work.
#include "common.cuh"

namespace {

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
void launch(const int8_t* x, const int8_t* w, const float* rs, const float* cs,
            OutT* out, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  int8_matmul_kernel<TM, TN, BK, OutT><<<grid, 256, 0, stream>>>(
      x, w, rs, cs, out, M, N, K);
}

template <typename OutT>
void dispatch(const int8_t* x, const int8_t* w, const float* rs,
              const float* cs, OutT* out, int M, int N, int K,
              cudaStream_t stream) {
  if (M <= 16)
    launch<1, 1, 128>(x, w, rs, cs, out, M, N, K, stream);
  else
    launch<4, 4, 32>(x, w, rs, cs, out, M, N, K, stream);
}

}  // namespace

// x (M, K) int8, w (K, N) int8, rs (M) f32, cs (N) f32, all contiguous;
// out (M, N) in the carrier (out_dtype: 0 float32, 1 bfloat16).
extern "C" int repro_int8_matmul(const void* x, const void* w, const void* rs,
                                 const void* cs, void* out, int M, int N, int K,
                                 int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto rp = static_cast<const float*>(rs);
  auto cp = static_cast<const float*>(cs);
  if (out_dtype == kFloat32)
    dispatch(xp, wp, rp, cp, static_cast<float*>(out), M, N, K, s);
  else if (out_dtype == kBFloat16)
    dispatch(xp, wp, rp, cp, static_cast<__nv_bfloat16*>(out), M, N, K, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
