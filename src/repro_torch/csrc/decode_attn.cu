// One fused decode-attention step over the int8 KV cache, for Hopper
// (sm_90a): the dense cache strips and the paged pools share one body.
//
// Replaces: src/repro/kernels/decode_attn.py:decode_attention (its body is
// _decode_attn_kernel) and decode_attention_paged (body
// _paged_decode_attn_kernel, the same compute with page-routed DMA).  Per
// (slot b, kv head): attend the G grouped query rows over the slot's
// logical cache rows t < pos[b] (the K scale folded into the scores, the V
// scale into the probabilities, softmax in fp32), quantize the step's new
// K/V row (scale = max(absmax, 1e-12) / qmax, payload = clip(rint(x /
// scale), qmin, qmax), an IEEE division), fold that quantized row into the
// softmax, and write payload and scale IN PLACE at logical row min(pos[b],
// S - 1) -- the pos == S clamp is the freed slot that keeps riding the
// batched step.  The JAX kernels alias their outputs onto the cache
// buffers; this one mutates the buffers it is given.
//
// Where logical row t of slot b lives is the only difference between the
// two entry points, so the body is templated on a row-address functor:
// DenseRows maps it to b * S + t of a (B, S, K, hd) strip, PagedRows to
// table[b, t / page] * page + t % page of a (P, page, K, hd) pool.  Chunks
// are cut on logical rows, never on pages, so the paged step runs the same
// arithmetic as the dense step on the same logical cache and equals it bit
// for bit at any page size (pages smaller than a chunk, or larger).  Rows
// at or past pos[b] are never read, so no page past a slot's live pages is
// touched.
//
// Bound: bytes.  A step reads each slot's live rows once (hd int8 + one
// fp32 scale, for K and V) and writes one row.  Per (query row, cache row)
// it does 4 * hd FLOPs against 2 * (hd + 4) bytes: at G = 1 and hd = 64
// about 2 FLOPs a byte, far below the card's fp32 ratio of about 20 (67
// TFLOP/s of CUDA-core fp32 against 3.35 TB/s).  At G = 16 it is near that
// line (about 30 FLOPs a byte); tensor cores for large groups are later
// work.  So the kernel keeps CUDA cores and spends its design on keeping
// bytes in flight across the whole card.
//
// Design (flash-decoding):
//  1. decode_chunk_kernel: one block of 128 threads per (kv head, chunk of
//     CHUNK logical rows, slot); a block whose chunk starts at or past
//     n_valid = min(pos[b], S) exits at once, so the host never reads pos.
//     At GPT-2 small's serving shape (16 slots, 1024 rows, 12 kv heads) that
//     is 1,536 blocks, about half of them live under ragged positions,
//     against 192 blocks that each walked a whole slot before.
//  2. Loads: each thread resolves its row's address once per sub-tile and
//     starts one 16-byte cp.async of K and one of V (a sub-tile is 128 x 16
//     bytes of each: 32 rows at hd 64, 16 at hd 128, 8 at hd 256) and, on
//     the row's first thread, the two fp32 scales.  The chunk fits in
//     shared memory (about 17 KB at hd 64, 77-89 KB at hd 256 and G = 8-16,
//     over the opt-in), so every sub-tile's loads start up front, one
//     commit group each, and sub-tile j's scores are computed while j + 1...
//     still land (at hd 256's 16 sub-tiles the wait counts at most 7
//     groups in flight, so the first waits take more than they need);
//     several blocks an SM keep the rest of the bytes in flight.
//     TMA is not used: a pool row's 64 bytes sit at a stride of K * hd, and
//     a page can be shorter than a box.
//  3. Scores: the hd / 16 threads of a row each dot their 16 K bytes with
//     the matching slice of q * scale (fp32) and reduce with shuffles; the
//     guarded K scale multiplies the sum.  A row's lanes form an aligned
//     group of LG = hd / 16 rounded up to a power of two (the shuffles'
//     butterfly needs one inside a warp); at hd 160 (Zamba2) that is 16
//     lanes for 10 segments, lanes 10-15 of each group idle and adding
//     zeros, so a sub-tile holds 8 rows and a chunk 16 sub-tiles, as at
//     hd 256.  Int8 is widened with a byte
//     permute and one fp32 add (exact), not the int-to-float conversion,
//     whose pipe runs at a sixteenth of the FMA rate.  The chunk's softmax
//     (max m, sum l, p * g(vs)) runs one warp per query row.  P.V: thread
//     (16-column slice, query row, row phase r) accumulates its slice over
//     rows r, r + R, ... (R = 128 / (G * hd / 16)), so every thread works at
//     G = 1 as at G = 16 -- at hd 256 and G = 16 (16 slices x 16 rows =
//     256 items) R is 1 and a thread takes two items; the R partials add
//     in shared memory in r order.
//     The chunk writes (m, l, acc[G][hd]) in fp32 to the workspace.
//  4. decode_combine_kernel, one block per (kv head, slot), a
//     programmatic dependent launch (the card may start it while the chunk
//     grid drains): it quantizes and scores the new row, waits for the
//     chunk grid (griddepcontrol.wait), combines the chunks in chunk order
//     0..n-1 (M = max m_c; L = sum exp(m_c - M) l_c; A likewise), folds in
//     the new row, divides, casts, and writes the new row in place -- after
//     every chunk has read the cache, which matters at pos == S, where the
//     clamped write lands on a row the last chunk reads.  No atomics: two
//     launches on the same inputs give the same bits.  The wrappers
//     allocate the workspace; the kernels allocate nothing.
// Measured on the H100 (PERF.md): about 4x the bound at the serving shape,
// 2x below SDPA on dequantized K/V.  Two launches' floor, the chunk data's
// arrival from L2 and the widening's instruction count each take a few
// microseconds.  Tried and slower: 256- and 64-row chunks, a last-arriving
// chunk block that combines (a counter per (slot, kv head)), the softmax
// on every warp, and K loaded before V with P.V per V sub-tile.
#include "common.cuh"
#include "sm90.cuh"

namespace {

// logical rows per chunk (kernels/decode_attn.py:DECODE_CHUNK)
constexpr int CHUNK = 128;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` commit groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// 16 int8 -> 16 exact floats: byte x becomes the float 2^23 + (x + 128)
// by a byte permute, and one add takes 2^23 + 128 away
__device__ __forceinline__ void widen16(const uint4& w, float* f) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = words[k] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * k + i] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
          8388736.0f;
  }
}

// workspace of one (slot, kv head, chunk): m[G], l[G], acc[G][HD]
__device__ __forceinline__ size_t ws_offset(int b, int kh, int c, int KH,
                                            int NC, int G, int HD) {
  return ((static_cast<size_t>(b) * KH + kh) * NC + c) * G * (HD + 2);
}

// lanes that take one cache row: its NS = HD / 16 segments rounded up to a
// power of two, so that the row's shuffle butterfly stays in an aligned
// group of a warp
__host__ __device__ constexpr int lane_group(int ns) {
  return ns <= 1 ? 1 : 2 * lane_group((ns + 1) / 2);
}

template <int HD>
__host__ __device__ constexpr int payload_bytes() {  // K, then P.V partials
  return CHUNK * HD > THREADS * 16 * 4 ? CHUNK * HD : THREADS * 16 * 4;
}

template <int HD>
size_t chunk_smem(int G) {
  return payload_bytes<HD>() + CHUNK * HD + 2 * CHUNK * sizeof(float) +
         (G * HD + G * CHUNK) * sizeof(float);
}

// one block per (kv head kh, chunk c, slot b): the chunk's (m, l, acc)
template <int HD, typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_chunk_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ ks,
                    const int8_t* __restrict__ vq,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    float* __restrict__ ws, Rows rows, int KH, int G, int NC,
                    float scale) {
  constexpr int NS = HD / 16;           // 16-byte segments of a row
  constexpr int LG = lane_group(NS);    // lanes of a row (NS or more)
  constexpr int RP = THREADS / LG;      // rows of a sub-tile
  constexpr int NG = CHUNK / RP;        // sub-tiles of a chunk (2 to 16)
  constexpr int PB = payload_bytes<HD>();
  static_assert(HD % 16 == 0 && NS <= LG && LG <= 32 && (LG & (LG - 1)) == 0,
                "a row's lanes: an aligned power-of-two group in a warp");
  static_assert(THREADS % LG == 0 && CHUNK % RP == 0 && NG * RP == CHUNK,
                "the sub-tiles tile the chunk exactly");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sk = reinterpret_cast<int8_t*>(smem);           // [CHUNK][HD]
  int8_t* sv = sk + PB;                                     // [CHUNK][HD]
  float* sks = reinterpret_cast<float*>(sv + CHUNK * HD);   // [CHUNK]
  float* svs = sks + CHUNK;                                 // [CHUNK]
  float* qs = svs + CHUNK;                                  // [G][HD]
  float* sc = qs + G * HD;           // [G][CHUNK] scores, then p * g(vs)
  float* red = reinterpret_cast<float*>(sk);  // [R][G][HD] after the scores

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int n_valid = max(0, min(pos[b], rows.len()));
  const int t0 = c * CHUNK;
  if (t0 >= n_valid) return;
  const int n = min(CHUNK, n_valid - t0);

  // lanes past a row's NS segments (hd 160) load nothing and add zeros
  const int rr = tid / LG, seg = tid % LG;
  const bool live_seg = seg < NS;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int i = j * RP + rr;
    if (i < n && live_seg) {
      const size_t r = rows(b, t0 + i) * KH + kh;
      cp_async16(sk + i * HD + seg * 16, kq + r * HD + seg * 16);
      cp_async16(sv + i * HD + seg * 16, vq + r * HD + seg * 16);
      if (seg == 0) {
        cp_async4(sks + i, ks + r);
        cp_async4(svs + i, vs + r);
      }
    }
    cp_async_commit();
  }
  const T* qb = q + (static_cast<size_t>(b) * KH + kh) * G * HD;
  for (int e = tid; e < G * HD; e += THREADS) qs[e] = to_f32(qb[e]) * scale;
  __syncthreads();

  // scores of each sub-tile as it lands: a thread reads only the K bytes
  // (and, on a row's first thread, the scale) it loaded itself, so its own
  // wait suffices; every lane takes part in the shuffles (rows past n
  // compute on stale bytes and are not stored)
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    cp_async_wait(NG - 1 - j);
    const int i = j * RP + rr;
    float kf[16];
    if (live_seg)
      widen16(*reinterpret_cast<const uint4*>(sk + i * HD + seg * 16), kf);
    const float ksg = seg == 0 && i < n ? scale_guard(sks[i]) : 0.0f;
    for (int g = 0; g < G; ++g) {
      float a = 0.0f;
      if (live_seg) {
        const float4* q4 =
            reinterpret_cast<const float4*>(qs + g * HD + seg * 16);
        float part[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v = q4[k];
          part[k] = fmaf(v.w, kf[4 * k + 3],
                         fmaf(v.z, kf[4 * k + 2],
                              fmaf(v.y, kf[4 * k + 1], v.x * kf[4 * k])));
        }
        a = (part[0] + part[1]) + (part[2] + part[3]);
      }
#pragma unroll
      for (int o = LG / 2; o > 0; o >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      if (seg == 0 && i < n) sc[g * CHUNK + i] = a * ksg;
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per query row
  float* wsb = ws + ws_offset(b, kh, c, KH, NC, G, HD);
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sc + g * CHUNK;
    float mx = -1e30f;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sg[i]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sg[i] - mx);
      sum += p;
      sg[i] = p * scale_guard(svs[i]);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      wsb[g] = mx;
      wsb[G + g] = sum;
    }
  }
  __syncthreads();

  // P.V: work item w = (slice sl, query row gg, row phase r) over rows r,
  // r + R, ...; at most one item a thread while NS * G <= THREADS, and
  // NS * G / THREADS items (R = 1) above it (hd 256 at G > 8)
  const int combos = NS * G;
  const int R = max(1, THREADS / combos);
  for (int w = tid; w < combos * R; w += THREADS) {
    const int sl = w % NS, gg = (w / NS) % G, r = w / combos;
    float acc[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc[u] = 0.0f;
    const float* pg = sc + gg * CHUNK;
    for (int i = r; i < n; i += R) {
      float vf[16];
      widen16(*reinterpret_cast<const uint4*>(sv + i * HD + sl * 16), vf);
      const float p = pg[i];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc[u] = fmaf(p, vf[u], acc[u]);
    }
    float4* dst =
        reinterpret_cast<float4*>(red + (r * G + gg) * HD + sl * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                           acc[4 * k + 3]);
  }
  __syncthreads();
  float* wacc = wsb + 2 * G;
  for (int e = tid; e < G * HD; e += THREADS) {
    float a = 0.0f;
#pragma unroll 8
    for (int k = 0; k < R; ++k) a += red[k * G * HD + e];
    wacc[e] = a;
  }
}

// one block per (kv head kh, slot b): the new row, the chunks in order,
// the output and the in-place write
template <int HD, typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const T* __restrict__ q, int8_t* __restrict__ kq,
                      float* __restrict__ ks, int8_t* __restrict__ vq,
                      float* __restrict__ vs, const T* __restrict__ new_k,
                      const T* __restrict__ new_v,
                      const int* __restrict__ pos,
                      const float* __restrict__ ws, T* __restrict__ out,
                      Rows rows, int KH, int G, int NC, float scale, int qmin,
                      int qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [G][HD], q * scale
  float* nk = qs + G * HD;       // [HD], new K payload (integer values)
  float* nv = nk + HD;           // [HD], new V payload
  float* nsc = nv + HD;          // [2], new K and V scales
  float* snew = nsc + 2;         // [G], the new row's scores

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int S = rows.len();
  const int p = pos[b];
  const int n_valid = max(0, min(p, S));
  const int nc = (n_valid + CHUNK - 1) / CHUNK;   // live chunks
  const int row = max(0, min(p, S - 1));          // scatter target

  // before the wait: nothing here reads what the chunk kernel writes
  const T* qb = q + (static_cast<size_t>(b) * KH + kh) * G * HD;
  for (int e = tid; e < G * HD; e += THREADS) qs[e] = to_f32(qb[e]) * scale;
  if (warp < 2) {
    // quantize the step's new row: warp 0 takes K, warp 1 takes V
    const T* src = (warp == 0 ? new_k : new_v) +
                   (static_cast<size_t>(b) * KH + kh) * HD;
    float x[HD / 32];
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < HD / 32; ++k) {
      x[k] = to_f32(src[lane + 32 * k]);
      amax = fmaxf(amax, fabsf(x[k]));
    }
    const float s = fmaxf(warp_max(amax), 1e-12f) / static_cast<float>(qmax);
    float* dst = warp == 0 ? nk : nv;
#pragma unroll
    for (int k = 0; k < HD / 32; ++k)
      dst[lane + 32 * k] =
          fminf(fmaxf(rintf(x[k] / s), static_cast<float>(qmin)),
                static_cast<float>(qmax));
    if (lane == 0) nsc[warp] = s;
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float a = 0.0f;
    for (int d = lane; d < HD; d += 32)
      a += qs[g * HD + d] * (nk[d] * nsc[0]);
    a = warp_sum(a);
    if (lane == 0) snew[g] = a;
  }
  __syncthreads();

  // every chunk has written its partials and read the cache
  grid_dependency_wait();
  const float* wsb = ws + ws_offset(b, kh, 0, KH, NC, G, HD);
  const size_t wstride = static_cast<size_t>(G) * (HD + 2);
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float m = -1e30f;
    for (int k = 0; k < nc; ++k) m = fmaxf(m, wsb[k * wstride + g]);
    float l = 0.0f, a = 0.0f;
    for (int k = 0; k < nc; ++k) {
      const float* w = wsb + k * wstride;
      const float f = expf(w[g] - m);
      l += f * w[G + g];
      a += f * w[2 * G + e];
    }
    // fold the freshly quantized row into the softmax
    const float s_new = snew[g];
    const float m_new = fmaxf(m, s_new);
    const float alpha = expf(m - m_new);
    const float p_new = expf(s_new - m_new);
    l = alpha * l + p_new;
    a = a * alpha + p_new * (nv[d] * nsc[1]);
    out[(static_cast<size_t>(b) * KH + kh) * G * HD + e] =
        from_f32<T>(a / fmaxf(l, 1e-30f));
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

template <int HD>
size_t combine_smem(int G) {
  return (G * HD + 2 * HD + 2 + G) * sizeof(float);
}

struct Args {
  const void *q, *new_k, *new_v, *pos;
  void *kq, *ks, *vq, *vs, *out;
  float* ws;
  int B, KH, G, NC;
  float scale;
  int qmin, qmax;
  cudaStream_t stream;
};

template <int HD, typename T, typename Rows>
int launch(const Args& a, Rows rows) {
  const size_t smem = chunk_smem<HD>(a.G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_chunk_kernel<HD, T, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_chunk_kernel<HD, T, Rows>
      <<<dim3(a.KH, a.NC, a.B), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos), a.ws,
      rows, a.KH, a.G, a.NC, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch_pdl(
      decode_combine_kernel<HD, T, Rows>, dim3(a.KH, a.B), dim3(THREADS),
      combine_smem<HD>(a.G), a.stream, static_cast<const T*>(a.q),
      static_cast<int8_t*>(a.kq),
      static_cast<float*>(a.ks), static_cast<int8_t*>(a.vq),
      static_cast<float*>(a.vs), static_cast<const T*>(a.new_k),
      static_cast<const T*>(a.new_v), static_cast<const int*>(a.pos),
      static_cast<const float*>(a.ws), static_cast<T*>(a.out), rows, a.KH,
      a.G, a.NC, a.scale, a.qmin, a.qmax);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

template <typename Rows>
int dispatch(int HD, int dtype, int S, const Args& a, Rows rows) {
  if (a.G < 1 || a.G > 16 || a.NC != (S + CHUNK - 1) / CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    switch (HD) {
      case 32: return launch<32, float>(a, rows);
      case 64: return launch<64, float>(a, rows);
      case 128: return launch<128, float>(a, rows);
      case 160: return launch<160, float>(a, rows);
      case 256: return launch<256, float>(a, rows);
    }
  } else if (dtype == kBFloat16) {
    switch (HD) {
      case 32: return launch<32, __nv_bfloat16>(a, rows);
      case 64: return launch<64, __nv_bfloat16>(a, rows);
      case 128: return launch<128, __nv_bfloat16>(a, rows);
      case 160: return launch<160, __nv_bfloat16>(a, rows);
      case 256: return launch<256, __nv_bfloat16>(a, rows);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// logical rows per chunk: the wrappers size the workspace by it
extern "C" int repro_decode_chunk() { return CHUNK; }

// q (B, KH, G, HD), new_k/new_v (B, KH, HD) and out (B, KH, G, HD) in the
// carrier (dtype 0 float32, 1 bfloat16); kq/vq (B, S, KH, HD) int8 and
// ks/vs (B, S, KH, 1) float32, updated in place; pos (B,) int32; ws a
// float32 workspace of B * KH * NC * G * (HD + 2) elements, NC = ceil(S /
// CHUNK) (refused otherwise).  All contiguous, the int8 caches 16-byte
// aligned; HD in {32, 64, 128, 160, 256}, G <= 16.
extern "C" int repro_decode_attn(const void* q, void* kq, void* ks, void* vq,
                                 void* vs, const void* new_k,
                                 const void* new_v, const void* pos, void* out,
                                 void* ws, int B, int S, int KH, int G, int HD,
                                 int NC, float scale, int qmin, int qmax,
                                 int dtype, void* stream) {
  const Args a{q, new_k, new_v, pos, kq, ks, vq, vs, out,
               static_cast<float*>(ws), B, KH, G, NC, scale, qmin, qmax,
               static_cast<cudaStream_t>(stream)};
  return dispatch(HD, dtype, S, a, DenseRows{S});
}

// As repro_decode_attn over page pools: kq/vq (P, page, KH, HD) int8 and
// ks/vs (P, page, KH, 1) float32, updated in place; table (B, maxp) int32
// page ids (each < P; unmapped entries point at the trash page 0), so a
// slot's logical cache is maxp * page rows long and NC = ceil(maxp * page
// / CHUNK).
extern "C" int repro_decode_attn_paged(const void* q, void* kq, void* ks,
                                       void* vq, void* vs, const void* new_k,
                                       const void* new_v, const void* pos,
                                       const void* table, void* out, void* ws,
                                       int B, int maxp, int page, int KH,
                                       int G, int HD, int NC, float scale,
                                       int qmin, int qmax, int dtype,
                                       void* stream) {
  const Args a{q, new_k, new_v, pos, kq, ks, vq, vs, out,
               static_cast<float*>(ws), B, KH, G, NC, scale, qmin, qmax,
               static_cast<cudaStream_t>(stream)};
  return dispatch(HD, dtype, maxp * page, a,
                  PagedRows{static_cast<const int*>(table), maxp, page});
}
