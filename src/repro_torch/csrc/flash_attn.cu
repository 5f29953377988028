// Flash attention over fp K/V, forward and backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attn.py --
//   flash_attention_fwd (#7, the forward without the LSE rows) and
//   _fwd_with_lse (#8, the forward of the flash_attention custom VJP):
//     flash_fwd_kernel<.., LSE = false / true>;
//   _fa_bwd, its dK/dV pallas_call (#9): flash_bwd_dkdv_kernel;
//   _fa_bwd, its dQ pallas_call (#10): flash_bwd_dq_kernel.
// Layout (BH, S, d), each tensor contiguous, q/k/v/dO/outputs in the
// carrier (float32 or bfloat16), lse and delta (BH, Sq) float32.
//
// What is computed, in the reference's rounding order:
//   forward   s = (q_f32 * scale) . k_f32 (scale first), -1e30 where
//             kpos > q_offset + qpos, the online-softmax recurrence of
//             online_softmax_update (m from -1e30, l from 0) with p rounded
//             to v's type before the P.V product, o = acc / max(l, 1e-30),
//             lse = m + log(max(l, 1e-30));
//   backward  s = scale * (q_f32 . k_f32) (scale last), the same mask,
//             p = exp(s - lse) kept in fp32, dv += p^T dO,
//             ds = p * (dO . v - delta) * scale, dk += ds^T q (q unscaled),
//             dq += ds k.
// The floors on l propagate NaN (as jnp.maximum does), so a NaN in q
// reaches o, the LSE and every gradient it touches.
//
// Bound: all four run fp32 arithmetic on the CUDA cores, as the Pallas
// kernels do; per causally visible (query, key) pair the forward does 4*d
// FLOPs, dK/dV 8*d and dQ 6*d.  At the training shape (BH = 96, S = 1024,
// d = 64) the operations bound them (67 TFLOP/s fp32), not the bytes.
//
// Design, simple first: tiles of q and K/V staged in shared memory as fp32
// (zero-padded to HDP, the head dim rounded up to 32, so one template
// serves every multiple of 16 up to 256), a loop inside the block in place
// of the TPU grid's sequential axis, no atomics -- each output row is
// written once by the one block that owns it, so two launches give the
// same bits.  Score rows: a warp per query row, a lane per key (K/V rows
// padded to HDP + 1 floats, conflict-free).  Products over a tile: a lane
// owns HDP / 32 output columns and reuses each K/V (or q/dO) element it
// loads across all the rows its warp owns.  Any Sq and Skv: the ragged
// edges are guarded inside.  Tensor cores (wgmma), TMA and pipelining are
// later work.
#include "common.cuh"

namespace {

template <int HDP>
struct Tiles {
  static constexpr bool kBig = HDP > 128;
  static constexpr int BQ = kBig ? 32 : 64;  // query rows per tile
  static constexpr int BK = kBig ? 32 : 64;  // key rows per tile
  static constexpr int C = HDP / 32;         // output columns per lane
  static constexpr int NU = BK / 32;         // keys per lane in a score row
  static constexpr int KP = HDP + 1;         // padded K/V row stride
};

constexpr int FWD_WARPS = 4;   // forward and dQ blocks
constexpr int DKDV_WARPS = 8;  // dK/dV blocks

// max(l, 1e-30) that keeps a NaN l (jnp.maximum; fmaxf would drop it)
__device__ __forceinline__ float floor_l(float l) {
  return l < 1e-30f ? 1e-30f : l;
}

// x rounded to the carrier T and widened back (p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rows [r0, r0 + rows) of a (S, HD) slab into a (rows, stride) fp32 tile,
// times mul, zero outside the slab and in the padding columns
template <int HDP, typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int r0, int rows, int S, int HD,
                                      float mul) {
  for (int e = threadIdx.x; e < rows * HDP; e += blockDim.x) {
    const int r = e / HDP, d = e % HDP;
    const int g = r0 + r;
    dst[r * stride + d] =
        (g < S && d < HD) ? to_f32(src[static_cast<size_t>(g) * HD + d]) * mul
                          : 0.0f;
  }
}

// ---------------------------------------------------------------- forward
template <int HDP>
constexpr size_t fwd_smem_floats() {
  using L = Tiles<HDP>;
  return L::BQ * HDP + 2 * L::BK * L::KP + L::BQ * L::BK + 3 * L::BQ;
}

template <int HDP, typename T, bool LSE>
__global__ void __launch_bounds__(FWD_WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int HD,
                 float scale, int causal, int q_offset) {
  using L = Tiles<HDP>;
  constexpr int BQ = L::BQ, BK = L::BK, C = L::C, NU = L::NU, KP = L::KP;
  constexpr int RPW = BQ / FWD_WARPS;  // query rows per warp
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][HDP]  q * scale
  float* kt = qs + BQ * HDP;     // [BK][KP]
  float* vt = kt + BK * KP;      // [BK][KP]
  float* ps = vt + BK * KP;      // [BQ][BK]   p rounded to v's type
  float* mrow = ps + BQ * BK;    // [BQ]       running max
  float* lrow = mrow + BQ;       // [BQ]       running sum
  float* arow = lrow + BQ;       // [BQ]       this tile's rescale factor

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bh = blockIdx.x;
  // the heaviest (last) causal q tiles start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = k + bh * Skv * HD;
  const T* vb = v + bh * Skv * HD;
  stage<HDP>(qs, HDP, q + bh * Sq * HD, q0, BQ, Sq, HD, scale);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    mrow[r] = -1e30f;
    lrow[r] = 0.0f;
  }

  float acc[RPW][C];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

  // the block's last query position bounds the causally live kv tiles
  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_tiles = (Skv + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * BK;
    if (causal && t0 > last_q) break;
    __syncthreads();  // the previous tile's readers are done
    stage<HDP>(kt, KP, kb, t0, BK, Skv, HD, 1.0f);
    stage<HDP>(vt, KP, vb, t0, BK, Skv, HD, 1.0f);
    __syncthreads();

    // scores and the online-softmax update, a warp per query row, a lane
    // per key
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int qpos = q_offset + q0 + r;
      const float* qr = qs + r * HDP;
      float s[NU];
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float* kr = kt + (lane + 32 * u) * KP;
        float a = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HDP; ++d) a = fmaf(qr[d], kr[d], a);
        const int tj = t0 + lane + 32 * u;
        if (tj >= Skv || (causal && tj > qpos)) a = -1e30f;
        s[u] = a;
        mx = fmaxf(mx, a);
      }
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int j = lane + 32 * u;
        const float p = t0 + j < Skv ? expf(s[u] - m_new) : 0.0f;
        psum += p;
        ps[r * BK + j] = round_to<T>(p);
      }
      const float alpha = expf(m_old - m_new);
      const float l_new = alpha * lrow[r] + warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = l_new;
        arow[r] = alpha;
      }
    }
    __syncwarp();

    // acc = acc * alpha + p . v over the warp's rows
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float alpha = arow[warp * RPW + i];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    const float* pw = ps + warp * RPW * BK;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vt[j * KP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float p = pw[i * BK + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

  T* ob = o + bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float lf = floor_l(lrow[r]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) ob[static_cast<size_t>(qi) * HD + d] = from_f32<T>(acc[i][c] / lf);
    }
    if (LSE && lane == 0) lse[bh * Sq + qi] = mrow[r] + logf(lf);
  }
}

// -------------------------------------------------------------- dQ (#10)
template <int HDP>
constexpr size_t dq_smem_floats() {
  using L = Tiles<HDP>;
  return 2 * L::BQ * HDP + 2 * L::BK * L::KP + L::BQ * L::BK + 2 * L::BQ;
}

template <int HDP, typename T>
__global__ void __launch_bounds__(FWD_WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Skv, int HD, float scale, int causal,
                    int q_offset) {
  using L = Tiles<HDP>;
  constexpr int BQ = L::BQ, BK = L::BK, C = L::C, NU = L::NU, KP = L::KP;
  constexpr int RPW = BQ / FWD_WARPS;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][HDP]  q
  float* dos = qs + BQ * HDP;    // [BQ][HDP]  dO
  float* kt = dos + BQ * HDP;    // [BK][KP]
  float* vt = kt + BK * KP;      // [BK][KP]
  float* dsm = vt + BK * KP;     // [BQ][BK]   ds
  float* ls = dsm + BQ * BK;     // [BQ]       lse
  float* dls = ls + BQ;          // [BQ]       delta

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = k + bh * Skv * HD;
  const T* vb = v + bh * Skv * HD;
  stage<HDP>(qs, HDP, q + bh * Sq * HD, q0, BQ, Sq, HD, 1.0f);
  stage<HDP>(dos, HDP, dout + bh * Sq * HD, q0, BQ, Sq, HD, 1.0f);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    ls[r] = q0 + r < Sq ? lse[bh * Sq + q0 + r] : 0.0f;
    dls[r] = q0 + r < Sq ? delta[bh * Sq + q0 + r] : 0.0f;
  }

  float acc[RPW][C];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_tiles = (Skv + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * BK;
    if (causal && t0 > last_q) break;
    __syncthreads();
    stage<HDP>(kt, KP, kb, t0, BK, Skv, HD, 1.0f);
    stage<HDP>(vt, KP, vb, t0, BK, Skv, HD, 1.0f);
    __syncthreads();

    // ds, a warp per query row, a lane per key
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int qpos = q_offset + q0 + r;
      const float* qr = qs + r * HDP;
      const float* dr = dos + r * HDP;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int j = lane + 32 * u;
        const float* kr = kt + j * KP;
        const float* vr = vt + j * KP;
        float a = 0.0f, b = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HDP; ++d) {
          a = fmaf(qr[d], kr[d], a);
          b = fmaf(dr[d], vr[d], b);
        }
        // __fmul_rn: s is rounded before the subtraction, never fused
        float s = __fmul_rn(scale, a);
        const int tj = t0 + j;
        if (causal && tj > qpos) s = -1e30f;
        const float p = tj < Skv ? expf(s - ls[r]) : 0.0f;
        dsm[r * BK + j] = p * (b - dls[r]) * scale;
      }
    }
    __syncwarp();

    // dq += ds . k over the warp's rows
    const float* dw = dsm + warp * RPW * BK;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = kt[j * KP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float ds = dw[i * BK + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

  T* db = dq + bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + warp * RPW + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) db[static_cast<size_t>(qi) * HD + d] = from_f32<T>(acc[i][c]);
    }
  }
}

// ----------------------------------------------------------- dK/dV (#9)
template <int HDP>
constexpr size_t dkdv_smem_floats() {
  using L = Tiles<HDP>;
  return 2 * L::BK * L::KP + 2 * L::BQ * HDP + 2 * L::BQ * L::BK + 2 * L::BQ;
}

template <int HDP, typename T>
__global__ void __launch_bounds__(DKDV_WARPS * 32)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int HD,
                      float scale, int causal, int q_offset) {
  using L = Tiles<HDP>;
  constexpr int BQ = L::BQ, BK = L::BK, C = L::C, NU = L::NU, KP = L::KP;
  constexpr int RA = BQ / DKDV_WARPS;  // query rows per warp (scores)
  constexpr int RW = BK / DKDV_WARPS;  // key rows per warp (products)
  extern __shared__ float smem[];
  float* kt = smem;              // [BK][KP]
  float* vt = kt + BK * KP;      // [BK][KP]
  float* qs = vt + BK * KP;      // [BQ][HDP]  q
  float* dos = qs + BQ * HDP;    // [BQ][HDP]  dO
  float* pm = dos + BQ * HDP;    // [BQ][BK]   p
  float* dsm = pm + BQ * BK;     // [BQ][BK]   ds
  float* ls = dsm + BQ * BK;     // [BQ]       lse
  float* dls = ls + BQ;          // [BQ]       delta

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + bh * Sq * HD;
  const T* db = dout + bh * Sq * HD;
  stage<HDP>(kt, KP, k + bh * Skv * HD, k0, BK, Skv, HD, 1.0f);
  stage<HDP>(vt, KP, v + bh * Skv * HD, k0, BK, Skv, HD, 1.0f);

  float adk[RW][C], adv[RW][C];
#pragma unroll
  for (int jj = 0; jj < RW; ++jj)
#pragma unroll
    for (int c = 0; c < C; ++c) adk[jj][c] = adv[jj][c] = 0.0f;

  // the first query tile whose last position sees this block's first key
  int first = 0;
  if (causal) first = max(0, k0 - q_offset) / BQ;
  const int n_tiles = (Sq + BQ - 1) / BQ;
  for (int t = first; t < n_tiles; ++t) {
    const int t0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    stage<HDP>(qs, HDP, qb, t0, BQ, Sq, HD, 1.0f);
    stage<HDP>(dos, HDP, db, t0, BQ, Sq, HD, 1.0f);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      ls[r] = t0 + r < Sq ? lse[bh * Sq + t0 + r] : 0.0f;
      dls[r] = t0 + r < Sq ? delta[bh * Sq + t0 + r] : 0.0f;
    }
    __syncthreads();

    // p and ds, a warp per query row, a lane per key
    for (int i = 0; i < RA; ++i) {
      const int r = warp * RA + i;
      const int qpos = q_offset + t0 + r;
      const float* qr = qs + r * HDP;
      const float* dr = dos + r * HDP;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int j = lane + 32 * u;
        const float* kr = kt + j * KP;
        const float* vr = vt + j * KP;
        float a = 0.0f, b = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HDP; ++d) {
          a = fmaf(qr[d], kr[d], a);
          b = fmaf(dr[d], vr[d], b);
        }
        float s = __fmul_rn(scale, a);
        if (causal && k0 + j > qpos) s = -1e30f;
        const float p = (t0 + r < Sq && k0 + j < Skv) ? expf(s - ls[r]) : 0.0f;
        pm[r * BK + j] = p;
        dsm[r * BK + j] = p * (b - dls[r]) * scale;
      }
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T q over the warp's key rows
    const int j0 = warp * RW;
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float dov[C], qv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dov[c] = dos[r * HDP + lane + 32 * c];
        qv[c] = qs[r * HDP + lane + 32 * c];
      }
#pragma unroll
      for (int jj = 0; jj < RW; ++jj) {
        const float p = pm[r * BK + j0 + jj];
        const float ds = dsm[r * BK + j0 + jj];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          adv[jj][c] = fmaf(p, dov[c], adv[jj][c]);
          adk[jj][c] = fmaf(ds, qv[c], adk[jj][c]);
        }
      }
    }
  }

  T* dkb = dk + bh * Skv * HD;
  T* dvb = dv + bh * Skv * HD;
#pragma unroll
  for (int jj = 0; jj < RW; ++jj) {
    const int kj = k0 + warp * RW + jj;
    if (kj >= Skv) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        dkb[static_cast<size_t>(kj) * HD + d] = from_f32<T>(adk[jj][c]);
        dvb[static_cast<size_t>(kj) * HD + d] = from_f32<T>(adv[jj][c]);
      }
    }
  }
}

// ----------------------------------------------------------------- host
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int BH, Sq, Skv, HD;
  float scale;
  int causal, q_offset;
  cudaStream_t stream;
};

enum Which { kFwd, kBwdDq, kBwdDkdv };

template <int HDP, typename T>
int launch(Which which, const Args& a) {
  using L = Tiles<HDP>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const dim3 q_grid(a.BH, (a.Sq + L::BQ - 1) / L::BQ);
  int e = 0;
  if (which == kFwd) {
    const size_t smem = fwd_smem_floats<HDP>() * sizeof(float);
    if (a.lse_out != nullptr) {
      auto kern = flash_fwd_kernel<HDP, T, true>;
      if ((e = set_smem(kern, smem))) return e;
      kern<<<q_grid, FWD_WARPS * 32, smem, a.stream>>>(
          q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out),
          a.Sq, a.Skv, a.HD, a.scale, a.causal, a.q_offset);
    } else {
      auto kern = flash_fwd_kernel<HDP, T, false>;
      if ((e = set_smem(kern, smem))) return e;
      kern<<<q_grid, FWD_WARPS * 32, smem, a.stream>>>(
          q, k, v, static_cast<T*>(a.o), nullptr, a.Sq, a.Skv, a.HD,
          a.scale, a.causal, a.q_offset);
    }
  } else if (which == kBwdDq) {
    const size_t smem = dq_smem_floats<HDP>() * sizeof(float);
    auto kern = flash_bwd_dq_kernel<HDP, T>;
    if ((e = set_smem(kern, smem))) return e;
    kern<<<q_grid, FWD_WARPS * 32, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.Sq,
        a.Skv, a.HD, a.scale, a.causal, a.q_offset);
  } else {
    const size_t smem = dkdv_smem_floats<HDP>() * sizeof(float);
    auto kern = flash_bwd_dkdv_kernel<HDP, T>;
    if ((e = set_smem(kern, smem))) return e;
    const dim3 kv_grid(a.BH, (a.Skv + L::BK - 1) / L::BK);
    kern<<<kv_grid, DKDV_WARPS * 32, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Skv, a.HD, a.scale, a.causal,
        a.q_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_hd(Which which, const Args& a) {
  if (a.HD < 16 || a.HD > 256 || a.HD % 16 || a.BH < 1 || a.Sq < 1 ||
      a.Skv < 1 || a.q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.HD + 31) / 32) {
    case 1: return launch<32, T>(which, a);
    case 2: return launch<64, T>(which, a);
    case 3: return launch<96, T>(which, a);
    case 4: return launch<128, T>(which, a);
    case 5: return launch<160, T>(which, a);
    case 6: return launch<192, T>(which, a);
    case 7: return launch<224, T>(which, a);
    default: return launch<256, T>(which, a);
  }
}

int dispatch(Which which, const Args& a, int dtype) {
  if (dtype == kFloat32) return by_hd<float>(which, a);
  if (dtype == kBFloat16) return by_hd<__nv_bfloat16>(which, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (BH, Sq, HD), k/v (BH, Skv, HD) -> o (BH, Sq, HD), all in the carrier
// (dtype 0 float32, 1 bfloat16); lse (BH, Sq) float32, or null for the
// forward without it (#7).  HD a multiple of 16 in [16, 256].
extern "C" int repro_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int BH,
                                    int Sq, int Skv, int HD, float scale,
                                    int causal, int q_offset, int dtype,
                                    void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr,
         nullptr, BH, Sq, Skv, HD, scale, causal, q_offset,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, a, dtype);
}

// dK, dV (BH, Skv, HD) from q, k, v, dO (carrier) and lse, delta (BH, Sq)
extern "C" int repro_flash_attn_bwd_dkdv(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int BH, int Sq,
                                         int Skv, int HD, float scale,
                                         int causal, int q_offset, int dtype,
                                         void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv, BH,
         Sq, Skv, HD, scale, causal, q_offset,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kBwdDkdv, a, dtype);
}

// dQ (BH, Sq, HD) from the same inputs
extern "C" int repro_flash_attn_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int BH, int Sq, int Skv,
                                       int HD, float scale, int causal,
                                       int q_offset, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         BH, Sq, Skv, HD, scale, causal, q_offset,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kBwdDq, a, dtype);
}
