// One fused decode-attention step over the int8 KV cache, for Hopper
// (sm_90a): the dense cache strips and the paged pools share one body.
//
// Replaces: src/repro/kernels/decode_attn.py:decode_attention (its body is
// _decode_attn_kernel) and decode_attention_paged (body
// _paged_decode_attn_kernel, the same compute with page-routed DMA).  Per
// (slot b, kv head): attend the G grouped query rows over the slot's
// logical cache rows t < pos[b] (the K scale folded into the scores, the V
// scale into the probabilities, online softmax in fp32 from m = -1e30),
// quantize the step's new K/V row (scale = max(absmax, 1e-12) / qmax,
// payload = clip(rint(x / scale), qmin, qmax), an IEEE division), fold that
// quantized row into the softmax, and write payload and scale IN PLACE at
// logical row min(pos[b], S - 1) -- the pos == S clamp is the freed slot
// that keeps riding the batched step.  The JAX kernels alias their outputs
// onto the cache buffers; this one mutates the buffers it is given.
//
// Where logical row t of slot b lives is the only difference between the
// two entry points, so the body is templated on a row-address functor:
// DenseRows maps it to b * S + t of a (B, S, K, hd) strip, PagedRows to
// table[b, t / page] * page + t % page of a (P, page, K, hd) pool.  Both
// walk the same 128-row logical tiles with the same arithmetic, so the
// paged step equals the dense step bit for bit on the same logical cache
// at any page size (pages smaller than a tile, or larger).  The JAX paged
// kernel instead makes the page its kv tile; rows past pos[b] are never
// read here either, so no page past a slot's live pages is touched.
//
// Bound: bytes.  A step reads each slot's live rows once (hd int8 + one
// fp32 scale, for K and V) and writes one row; its arithmetic is 4*hd FLOPs
// per (query row, cache row), far below the card's ratio of operations to
// bytes.
//
// Design, simple first: one block of 128 threads per (kv head, slot); a
// loop over 128-row logical tiles up to pos[b] replaces the TPU grid's
// sequential kv axis.  Phase A: one thread per cache row resolves the row's
// address (kept in shared memory for phase C), reads its K row with 16-byte
// loads and computes the G scores.  Phase B: a warp per query row takes the
// tile max, rescales the running (m, l) and turns scores into p * g(vs).
// Phase C: one thread per (query row, column) accumulates p . V over the
// tile's rows.  A pool row starts at ((pid * page + r) * K + kh) * hd bytes,
// 16-byte aligned for hd in {32, 64, 128}.  Split-KV across blocks and
// wider loads are later work.
#include "common.cuh"

namespace {

constexpr int BT = 128;       // cache rows per tile == threads per block
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// logical row t of slot b -> row index r of the buffer: the K/V payload of
// (r, kv head kh) starts at (r * KH + kh) * HD, its scale at r * KH + kh
struct DenseRows {                 // (B, S, K, hd) strips
  int S;
  __device__ int len() const { return S; }
  __device__ size_t operator()(int b, int t) const {
    return static_cast<size_t>(b) * S + t;
  }
};

struct PagedRows {                 // (P, page, K, hd) pools + (B, maxp) table
  const int* table;
  int maxp, page;
  __device__ int len() const { return maxp * page; }
  __device__ size_t operator()(int b, int t) const {
    return static_cast<size_t>(table[b * maxp + t / page]) * page + t % page;
  }
};

template <int HD, typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, int8_t* __restrict__ kq,
              float* __restrict__ ks, int8_t* __restrict__ vq,
              float* __restrict__ vs, const T* __restrict__ new_k,
              const T* __restrict__ new_v, const int* __restrict__ pos,
              T* __restrict__ out, Rows rows, int KH, int G, float scale,
              int qmin, int qmax) {
  extern __shared__ float smem[];
  float* qs = smem;              // [G][HD], q * scale
  float* acc = qs + G * HD;      // [G][HD]
  float* sc = acc + G * HD;      // [G][BT], scores, then p * g(vs)
  float* vsc = sc + G * BT;      // [BT]
  float* ml = vsc + BT;          // m[G], l[G], alpha[G], p_new[G]
  float* nk = ml + 4 * G;        // [HD], new K payload (integer values)
  float* nv = nk + HD;           // [HD], new V payload
  float* nsc = nv + HD;          // [2], new K and V scales
  // [BT] row indices of the tile (after the floats: size_t alignment holds
  // because the float count is even for every G and HD)
  size_t* rid = reinterpret_cast<size_t*>(nsc + 2);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int S = rows.len();
  const int p = pos[b];
  const int n_valid = max(0, min(p, S));       // cache rows to attend
  const int row = max(0, min(p, S - 1));       // scatter target

  for (int e = tid; e < G * HD; e += THREADS) {
    qs[e] = to_f32(q[(static_cast<size_t>(b) * KH + kh) * G * HD + e]) * scale;
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ml[g] = -1e30f;
    ml[G + g] = 0.0f;
  }
  if (warp < 2) {
    // quantize the step's new row: warp 0 takes K, warp 1 takes V
    const T* src = (warp == 0 ? new_k : new_v) + (static_cast<size_t>(b) * KH + kh) * HD;
    float x[HD / 32];
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      x[c] = to_f32(src[lane + 32 * c]);
      amax = fmaxf(amax, fabsf(x[c]));
    }
    const float s = fmaxf(warp_max(amax), 1e-12f) / static_cast<float>(qmax);
    float* dst = warp == 0 ? nk : nv;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c)
      dst[lane + 32 * c] = fminf(fmaxf(rintf(x[c] / s), static_cast<float>(qmin)),
                                 static_cast<float>(qmax));
    if (lane == 0) nsc[warp] = s;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_valid; t0 += BT) {
    const int n = min(BT, n_valid - t0);
    // Phase A: scores of this thread's cache row
    if (tid < n) {
      const size_t r = rows(b, t0 + tid) * KH + kh;
      rid[tid] = r;
      const uint4* kr = reinterpret_cast<const uint4*>(kq + r * HD);
      const float ksg = scale_guard(ks[r]);
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * HD;
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) {
          const uint4 w4 = kr[c];
          const int8_t* kb = reinterpret_cast<const int8_t*>(&w4);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            a = fmaf(qg[c * 16 + u], static_cast<float>(kb[u]), a);
        }
        sc[g * BT + tid] = a * ksg;
      }
      vsc[tid] = scale_guard(vs[r]);
    }
    __syncthreads();
    // Phase B: online-softmax rescale, one warp per query row
    for (int g = warp; g < G; g += WARPS) {
      float mx = -1e30f;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[g * BT + i]);
      const float m_prev = ml[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int i = lane; i < n; i += 32) {
        const float pi = expf(sc[g * BT + i] - m_new);
        sum += pi;
        sc[g * BT + i] = pi * vsc[i];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ml[g] = m_new;
        ml[G + g] = alpha * ml[G + g] + sum;
        ml[2 * G + g] = alpha;
      }
    }
    __syncthreads();
    // Phase C: acc = acc * alpha + (p * g(vs)) . V
    for (int e = tid; e < G * HD; e += THREADS) {
      const int g = e / HD, d = e % HD;
      const float* pg = sc + g * BT;
      float a = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        a = fmaf(pg[i], static_cast<float>(vq[rid[i] * HD + d]), a);
      acc[e] = acc[e] * ml[2 * G + g] + a;
    }
    __syncthreads();
  }

  // fold the freshly quantized row into the softmax
  for (int g = warp; g < G; g += WARPS) {
    float a = 0.0f;
    for (int d = lane; d < HD; d += 32) a += qs[g * HD + d] * (nk[d] * nsc[0]);
    const float s_new = warp_sum(a);
    if (lane == 0) {
      const float m_prev = ml[g];
      const float m_new = fmaxf(m_prev, s_new);
      const float alpha = expf(m_prev - m_new);
      const float p_new = expf(s_new - m_new);
      ml[G + g] = alpha * ml[G + g] + p_new;
      ml[2 * G + g] = alpha;
      ml[3 * G + g] = p_new;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    const float a = acc[e] * ml[2 * G + g] + ml[3 * G + g] * (nv[d] * nsc[1]);
    out[(static_cast<size_t>(b) * KH + kh) * G * HD + e] =
        from_f32<T>(a / fmaxf(ml[G + g], 1e-30f));
  }
  // in-place scatter of the new row; every read of the cache is done
  const size_t wrow = rows(b, row) * KH + kh;
  for (int d = tid; d < HD; d += THREADS) {
    kq[wrow * HD + d] = static_cast<int8_t>(nk[d]);
    vq[wrow * HD + d] = static_cast<int8_t>(nv[d]);
  }
  if (tid == 0) {
    ks[wrow] = nsc[0];
    vs[wrow] = nsc[1];
  }
}

struct Args {
  const void *q, *new_k, *new_v, *pos;
  void *kq, *ks, *vq, *vs, *out;
  int B, KH, G;
  float scale;
  int qmin, qmax;
  cudaStream_t stream;
};

template <int HD, typename T, typename Rows>
int launch(const Args& a, Rows rows) {
  const size_t smem =
      (2 * a.G * HD + a.G * BT + BT + 4 * a.G + 2 * HD + 2) * sizeof(float) +
      BT * sizeof(size_t);
  dim3 grid(a.KH, a.B);
  decode_kernel<HD, T, Rows><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<int8_t*>(a.kq),
      static_cast<float*>(a.ks), static_cast<int8_t*>(a.vq),
      static_cast<float*>(a.vs), static_cast<const T*>(a.new_k),
      static_cast<const T*>(a.new_v), static_cast<const int*>(a.pos),
      static_cast<T*>(a.out), rows, a.KH, a.G, a.scale, a.qmin, a.qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows>
int dispatch(int HD, int dtype, const Args& a, Rows rows) {
  if (a.G < 1 || a.G > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    switch (HD) {
      case 32: return launch<32, float>(a, rows);
      case 64: return launch<64, float>(a, rows);
      case 128: return launch<128, float>(a, rows);
    }
  } else if (dtype == kBFloat16) {
    switch (HD) {
      case 32: return launch<32, __nv_bfloat16>(a, rows);
      case 64: return launch<64, __nv_bfloat16>(a, rows);
      case 128: return launch<128, __nv_bfloat16>(a, rows);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, KH, G, HD), new_k/new_v (B, KH, HD) and out (B, KH, G, HD) in the
// carrier (dtype 0 float32, 1 bfloat16); kq/vq (B, S, KH, HD) int8 and
// ks/vs (B, S, KH, 1) float32, updated in place; pos (B,) int32.  All
// contiguous, the int8 caches 16-byte aligned; HD in {32, 64, 128}, G <= 16.
extern "C" int repro_decode_attn(const void* q, void* kq, void* ks, void* vq,
                                 void* vs, const void* new_k,
                                 const void* new_v, const void* pos, void* out,
                                 int B, int S, int KH, int G, int HD,
                                 float scale, int qmin, int qmax, int dtype,
                                 void* stream) {
  const Args a{q, new_k, new_v, pos, kq, ks, vq, vs, out, B, KH, G,
               scale, qmin, qmax, static_cast<cudaStream_t>(stream)};
  return dispatch(HD, dtype, a, DenseRows{S});
}

// As repro_decode_attn over page pools: kq/vq (P, page, KH, HD) int8 and
// ks/vs (P, page, KH, 1) float32, updated in place; table (B, maxp) int32
// page ids (each < P; unmapped entries point at the trash page 0), so a
// slot's logical cache is maxp * page rows long.
extern "C" int repro_decode_attn_paged(const void* q, void* kq, void* ks,
                                       void* vq, void* vs, const void* new_k,
                                       const void* new_v, const void* pos,
                                       const void* table, void* out, int B,
                                       int maxp, int page, int KH, int G,
                                       int HD, float scale, int qmin,
                                       int qmax, int dtype, void* stream) {
  const Args a{q, new_k, new_v, pos, kq, ks, vq, vs, out, B, KH, G,
               scale, qmin, qmax, static_cast<cudaStream_t>(stream)};
  return dispatch(HD, dtype, a,
                  PagedRows{static_cast<const int*>(table), maxp, page});
}
