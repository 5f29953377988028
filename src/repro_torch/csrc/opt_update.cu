// One-pass AdamW with block-wise 8-bit moments, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/opt_update.py:fused_adamw_blocks (its body is
// _adamw_kernel).  Over a (rows, BS) bucket where each row is one
// quantization block of both moments: dequantize m1 and m2 (square m2 when
// its codec is sqrt-domain), fold the global-norm clip factor into g, apply
// the bias-corrected AdamW update with weight decay, requantize both
// moments per row (absmax, or min/max for an asymmetric codec), and write
// one partial sum of (lr * update)^2 per block of rows.  Updates the bucket
// in place: p and the six moment buffers are read and written by the same
// thread, so aliasing is safe.
//
// Bound: memory.  Per parameter it reads g and p (fp32) and two int8
// payloads and writes p and two payloads: 14 bytes, plus 8 bytes of scale
// and zero per moment and row (0.125 B a parameter each way for 128-wide
// rows) -- about 16.25 B a parameter, 2.0 GB for GPT-2 small's 124.5 M,
// 0.60 ms at 3.35 TB/s.  A few dozen flops a parameter are far below the
// fp32 rate.
//
// Design: one warp per row, BS / 32 values per lane at stride 32 (lane l
// holds elements l, l + 32, ...), so every load and store of a warp is one
// contiguous run; the row's absmax or min/max is a warp shuffle reduction.
// Eight warps take 64 rows per block, and each block writes one partial of
// the update norm, which the wrapper sums: no atomics.  The eight scalars
// (clip, lr, b1, b2, eps, wd, c1, c2; SMEM on the TPU) are read from a
// device array, so the step never waits for the host.  Arithmetic follows
// the reference op for op with explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA
// and the result equals the plain version's (kernels/opt_update.py) bit
// for bit; the 1e-12 guards and rint (half to even) are the reference's.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;

struct Codec {
  float qmin, qmax;
  int symmetric, sqrt_domain;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int VPT>
__device__ __forceinline__ void dequant(const int8_t* __restrict__ q,
                                        float s, float z, const Codec c,
                                        size_t base, int lane,
                                        float (&out)[VPT]) {
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    float d = __fmul_rn(s, __fadd_rn(static_cast<float>(q[base + v * 32 + lane]), z));
    out[v] = c.sqrt_domain ? __fmul_rn(d, d) : d;
  }
}

// quantize_int's block-wise row codec on one row held by a warp
template <int VPT>
__device__ __forceinline__ void requant(float (&x)[VPT], const Codec c,
                                        int8_t* __restrict__ q,
                                        float* __restrict__ s,
                                        float* __restrict__ z, size_t base,
                                        int row, int lane) {
  if (c.sqrt_domain) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) x[v] = __fsqrt_rn(fmaxf(x[v], 0.0f));
  }
  float scale, zero;
  if (c.symmetric) {
    float am = 0.0f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) am = fmaxf(am, fabsf(x[v]));
    am = warp_max(am);
    scale = __fdiv_rn(fmaxf(am, 1e-12f), c.qmax);
    zero = 0.0f;
  } else {
    float mn = x[0], mx = x[0];
#pragma unroll
    for (int v = 1; v < VPT; ++v) {
      mn = fminf(mn, x[v]);
      mx = fmaxf(mx, x[v]);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    scale = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), 1e-12f),
                      __fsub_rn(c.qmax, c.qmin));
    zero = __fsub_rn(rintf(__fdiv_rn(mn, scale)), c.qmin);
  }
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    float r = __fsub_rn(rintf(__fdiv_rn(x[v], scale)), zero);
    r = fminf(fmaxf(r, c.qmin), c.qmax);
    q[base + v * 32 + lane] = static_cast<int8_t>(static_cast<int>(r));
  }
  if (lane == 0) {
    s[row] = scale;
    z[row] = zero;
  }
}

template <int VPT>
__global__ void __launch_bounds__(kWarps * 32)
adamw_kernel(const float* __restrict__ sc, const float* __restrict__ g,
             float* __restrict__ p, int8_t* __restrict__ q1,
             float* __restrict__ s1, float* __restrict__ z1,
             int8_t* __restrict__ q2, float* __restrict__ s2,
             float* __restrict__ z2, float* __restrict__ partial, int rows,
             Codec m1, Codec m2, int wd_on) {
  constexpr int BS = 32 * VPT;
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float clip = sc[0], lr = sc[1], b1 = sc[2], b2 = sc[3];
  const float eps = sc[4], wd = sc[5], c1 = sc[6], c2 = sc[7];
  const float omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  float sumsq = 0.0f;

  for (int row = r0 + warp; row < r1; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * BS;
    float d1[VPT], d2[VPT];
    dequant<VPT>(q1, s1[row], z1[row], m1, base, lane, d1);
    dequant<VPT>(q2, s2[row], z2[row], m2, base, lane, d2);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const size_t i = base + v * 32 + lane;
      const float gg = __fmul_rn(g[i], clip);
      const float pv = p[i];
      d1[v] = __fadd_rn(__fmul_rn(b1, d1[v]), __fmul_rn(omb1, gg));
      d2[v] = __fadd_rn(__fmul_rn(b2, d2[v]),
                        __fmul_rn(omb2, __fmul_rn(gg, gg)));
      float upd = __fdiv_rn(__fdiv_rn(d1[v], c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(d2[v], c2)), eps));
      if (wd_on) upd = __fadd_rn(upd, __fmul_rn(wd, pv));
      const float delta = __fmul_rn(lr, upd);
      p[i] = __fsub_rn(pv, delta);
      sumsq += delta * delta;
    }
    requant<VPT>(d1, m1, q1, s1, z1, base, row, lane);
    requant<VPT>(d2, m2, q2, s2, z2, base, row, lane);
  }

  sumsq = warp_sum(sumsq);
  if (lane == 0) warp_sums[warp] = sumsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    partial[blockIdx.x] = t;
  }
}

template <int VPT>
void launch(const float* sc, const float* g, float* p, int8_t* q1, float* s1,
            float* z1, int8_t* q2, float* s2, float* z2, float* partial,
            int rows, Codec m1, Codec m2, int wd_on, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adamw_kernel<VPT><<<blocks, kWarps * 32, 0, stream>>>(
      sc, g, p, q1, s1, z1, q2, s2, z2, partial, rows, m1, m2, wd_on);
}

}  // namespace

// g, p (rows, bs) fp32; q1, q2 (rows, bs) int8; s1, z1, s2, z2 (rows) fp32;
// sc (8) fp32 device scalars; partial (ceil(rows / 64)) fp32 out.  p and
// the moment buffers are updated in place.  bs in {32, 64, 128, 256}.
// Codec: (qmin, qmax, symmetric, sqrt_domain) per moment.
extern "C" int repro_fused_adamw(const void* sc, const void* g, void* p,
                                 void* q1, void* s1, void* z1, void* q2,
                                 void* s2, void* z2, void* partial, int rows,
                                 int bs, int m1_qmin, int m1_qmax, int m1_sym,
                                 int m1_sqrt, int m2_qmin, int m2_qmax,
                                 int m2_sym, int m2_sqrt, int wd_on,
                                 void* stream) {
  const Codec m1{static_cast<float>(m1_qmin), static_cast<float>(m1_qmax),
                 m1_sym, m1_sqrt};
  const Codec m2{static_cast<float>(m2_qmin), static_cast<float>(m2_qmax),
                 m2_sym, m2_sqrt};
  auto s = static_cast<cudaStream_t>(stream);
  auto F = [](const void* x) { return static_cast<const float*>(x); };
  auto W = [](void* x) { return static_cast<float*>(x); };
  auto Q = [](void* x) { return static_cast<int8_t*>(x); };
  switch (bs) {
#define REPRO_ADAMW_CASE(V)                                                  \
  case 32 * V:                                                               \
    launch<V>(F(sc), F(g), W(p), Q(q1), W(s1), W(z1), Q(q2), W(s2), W(z2),   \
              W(partial), rows, m1, m2, wd_on, s);                           \
    break;
    REPRO_ADAMW_CASE(1)
    REPRO_ADAMW_CASE(2)
    REPRO_ADAMW_CASE(4)
    REPRO_ADAMW_CASE(8)
#undef REPRO_ADAMW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
