// Causal flash-attention forward over an int8 KV cache, for Hopper (sm_90a),
// on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attn.py:flash_attention_fwd_q8 (its
// body is _flash_fwd_q8_kernel): the int8-KV prefill of the serving path,
// at the float32 carrier (kernels/flash_attn.py:q8_library; the bf16
// carrier runs flash_q8_sm90.cu on the tensor cores).  Its bf16 instance
// stays as the yardstick the tensor-core kernel is timed against.
// q (B, Sq, H, hd) in the carrier; kq/vq (B, Skv, K, hd) int8 payloads with
// ks/vs (B, Skv, K, 1) fp32 per-(position, head) scales; GQA through kv head
// h / (H / K), no repeat.  s = ((q * 1/sqrt(hd)) . kq) * g(ks) (the K scale
// folded into the scores), online softmax in fp32 with m starting at -1e30,
// p * g(vs) (the V scale folded into the probabilities) against vq, and
// out = acc / max(l, 1e-30).  Masked scores are -1e30, as in the reference.
//
// Bound: at prefill the kernel reads q once and, per (batch, kv head), the
// causally visible K/V rows once (bytes); its arithmetic is 4*hd fp32 FLOPs
// per visible (query, key) pair on the CUDA cores.  At the serving shapes
// (Sq <= 512, hd = 64) the operations bound it (67 TFLOP/s fp32).
//
// Design, simple first: one block per (64-query tile, head, batch row),
// four warps of 16 query rows each.  A loop over 64-row kv tiles replaces
// the TPU grid's sequential kv axis and stops at the causal limit.  Each
// tile's payloads are widened to fp32 in shared memory; a lane computes the
// scores of two kv rows, the warp reduces max and sum by shuffles, and the
// probabilities go through shared memory to the P.V product, where a lane
// owns hd/32 output columns.  Dequantized K/V never reach device memory.
// At hd 256 (Gemma) a block takes 213,760 bytes of shared memory, one block
// an SM, and a lane holds 16 rows x 8 columns of the accumulator; at hd
// 160 (Zamba2) 140,032 bytes and 16 rows x 5 columns.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp

template <int HD>
constexpr size_t smem_floats() {
  return BQ * HD + BKV * (HD + 1) + BKV * HD + 2 * BKV + WARPS * RPW * BKV;
}

template <int HD, typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                const float* __restrict__ ks, const int8_t* __restrict__ vq,
                const float* __restrict__ vs, T* __restrict__ out, int Sq,
                int Skv, int H, int KH, float scale, int causal, int q_offset) {
  constexpr int C = HD / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][HD], q * scale
  float* kt = qs + BQ * HD;                // [BKV][HD + 1], kq as fp32
  float* vt = kt + BKV * (HD + 1);         // [BKV][HD], vq as fp32
  float* ksc = vt + BKV * HD;              // [BKV], guarded K scales
  float* vsc = ksc + BKV;                  // [BKV], guarded V scales
  float* ps = vsc + BKV;                   // [WARPS][RPW][BKV], p * g(vs)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);

  for (int e = tid; e < BQ * HD; e += WARPS * 32) {
    const int r = e / HD, d = e % HD;
    const int qi = q0 + r;
    qs[e] = qi < Sq
        ? to_f32(q[((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + d]) * scale
        : 0.0f;
  }

  float m[RPW], l[RPW], acc[RPW][C];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  // the last query position of this block bounds the causally live tiles
  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_tiles = (Skv + BKV - 1) / BKV;
  float* pw = ps + warp * RPW * BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * BKV;
    if (causal && t0 > last_q) break;
    __syncthreads();  // previous tile's readers are done
    for (int e = tid; e < BKV * HD; e += WARPS * 32) {
      const int j = e / HD, d = e % HD;
      const int tj = t0 + j;
      const size_t off = ((static_cast<size_t>(b) * Skv + tj) * KH + kh) * HD + d;
      kt[j * (HD + 1) + d] = tj < Skv ? static_cast<float>(kq[off]) : 0.0f;
      vt[j * HD + d] = tj < Skv ? static_cast<float>(vq[off]) : 0.0f;
    }
    for (int j = tid; j < BKV; j += WARPS * 32) {
      const int tj = t0 + j;
      const size_t off = (static_cast<size_t>(b) * Skv + tj) * KH + kh;
      ksc[j] = tj < Skv ? scale_guard(ks[off]) : 1.0f;
      vsc[j] = tj < Skv ? scale_guard(vs[off]) : 1.0f;
    }
    __syncthreads();

#pragma unroll  // full unroll keeps m, l and acc in registers
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int qpos = q_offset + q0 + r;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float* kr = kt + j * (HD + 1);
        const float* qr = qs + r * HD;
        float a = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) a = fmaf(qr[d], kr[d], a);
        a *= ksc[j];
        const int tj = t0 + j;
        if (tj >= Skv || (causal && tj > qpos)) a = -1e30f;
        s[u] = a;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
      float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      if (t0 + lane >= Skv) p0 = 0.0f;
      if (t0 + lane + 32 >= Skv) p1 = 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      pw[i * BKV + lane] = p0 * vsc[lane];
      pw[i * BKV + lane + 32] = p1 * vsc[lane + 32];
      __syncwarp();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = lane + 32 * c;
        float a = 0.0f;
#pragma unroll 16
        for (int j = 0; j < BKV; ++j) a = fmaf(pw[i * BKV + j], vt[j * HD + d], a);
        acc[i][c] = acc[i][c] * alpha + a;
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + warp * RPW + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      out[((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + d] =
          from_f32<T>(acc[i][c] / fmaxf(l[i], 1e-30f));
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, void* out, int B, int Sq, int Skv, int H, int KH,
           float scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_q8_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_q8_kernel<HD, T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<T*>(out), Sq, Skv, H, KH,
      scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_hd(int HD, const void* q, const void* kq, const void* ks,
          const void* vq, const void* vs, void* out, int B, int Sq, int Skv,
          int H, int KH, float scale, int causal, int q_offset,
          cudaStream_t s) {
  switch (HD) {
    case 32: return launch<32, T>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
    case 64: return launch<64, T>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
    case 128: return launch<128, T>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
    case 160: return launch<160, T>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
    case 256: return launch<256, T>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All tensors contiguous in the JAX layout; dtype is the carrier of q/out
// (0 float32, 1 bfloat16); hd in {32, 64, 128, 160, 256}.
extern "C" int repro_flash_attn_q8(const void* q, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, void* out, int B, int Sq,
                                   int Skv, int H, int KH, int HD, float scale,
                                   int causal, int q_offset, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return by_hd<float>(HD, q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
  if (dtype == kBFloat16)
    return by_hd<__nv_bfloat16>(HD, q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, scale, causal, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
