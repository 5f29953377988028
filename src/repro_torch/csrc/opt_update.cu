// One-pass AdamW with block-wise 8-bit moments, for Hopper (sm_90a), read
// from each leaf where it lies.
//
// Replaces: src/repro/kernels/opt_update.py:fused_adamw_blocks (its body is
// _adamw_kernel).  Over rows of `bs` values, each row one quantization
// block of both moments: dequantize m1 and m2 (square m2 when its codec is
// sqrt-domain), fold the global-norm clip factor into g, apply the
// bias-corrected AdamW update with weight decay, requantize both moments
// per row (absmax, or min/max for an asymmetric codec), and write one
// partial sum of (lr * update)^2 per block.
//
// The rows come from a table of segments (kernels/opt_update.py:
// segment_table), one per leaf: the source pointers of g, p and the six
// moment parts, the leaf's element count (its last row may be ragged:
// elements past the end read as 0, as flatten_blocks' padding does) and
// its first row in the output bucket.  fused_adamw_leaves passes one
// segment a leaf and a fresh bucket, so no concatenated copy of g, p and
// the moments is made; fused_adamw_blocks passes one segment whose source
// is its destination (in place: every thread writes only the rows it
// read).  A launch takes up to 256 segments, as a kernel parameter; the
// wrapper launches once for each further 256 leaves.
//
// Bound: memory.  Per parameter it reads g and p (fp32) and two int8
// payloads and writes p and two payloads: 14 bytes, plus 8 bytes of scale
// and zero per moment and row (0.125 B a parameter each way for 128-wide
// rows) -- about 16.25 B a parameter, 2.0 GB for GPT-2 small's 124.5 M,
// 0.60 ms at 3.35 TB/s.  The arithmetic, about a hundred fp32 instructions
// an element (five IEEE divisions and two square roots among them, each a
// short sequence), takes nearly as long at the card's issue rate, so the
// design runs the two under each other.
//
// Design: persistent blocks, three an SM, each walking tiles of 2048
// values (16 rows of 128) round robin.  A producer warp keeps a ring of
// three stages in shared memory filled by 1-D bulk copies (cp.async.bulk,
// no tensor map: g, p, both payloads and the four scale/zero runs of a
// tile, completed on the stage's mbarrier) while eight consumer warps
// update the tile that has landed and free its stage on a second mbarrier.
// A row is bs / 8 lanes (up to 32), each lane holding 8 values (16 at bs =
// 256) as 4-value chunks: it reads 16 bytes of g and p and 4 bytes of each
// payload from shared memory a chunk, and stores p 16 bytes and each
// payload 4 bytes a chunk.  Occupancy sets the time more than the ring
// depth: 24 consumer warps an SM, each with two rows' chains of divisions
// in flight, hid the arithmetic's latency best on GPT-2 small's bucket
// (H100; two stages and four blocks, a lane a 4-value chunk, and twelve
// warps a block all measured slower).  The row's absmax or
// min/max is a shuffle reduction over its lanes.  Tiles start on rows
// that are multiples of 4, so every copy (the 4-byte scales included) is
// a multiple of 16 bytes.  A segment whose pointers are not 16-byte
// aligned, the ragged last row of a leaf and its last full rows up to a
// multiple of 4 take a direct path inside the same kernel: element loads
// from global memory, the same arithmetic, element stores.  Each block
// writes one partial of the update norm, which the wrapper sums: no
// atomics, and the tiles' assignment to blocks depends only on the shapes
// and the grid, so a repeat is bit-identical.  The eight scalars (clip,
// lr, b1, b2, eps, wd, c1, c2; SMEM on the TPU) are read from a device
// array, so the step never waits for the host.  Arithmetic follows the
// reference op for op with explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA
// and the result equals the plain version's (kernels/opt_update.py) bit
// for bit; the 1e-12 guards and rint (half to even) are the reference's.
#include <string.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kStages = 3;
constexpr int kTileElems = 2048;  // values a tile: rows = kTileElems / bs
constexpr int kBarBytes = 128;    // the mbarriers, before the stages

struct Codec {
  float qmin, qmax;
  int symmetric, sqrt_domain;
};

// one leaf (or the whole bucket), 14 int64 as segment_table writes them
struct Segment {
  const float* g;
  const float* p;
  const int8_t* q1;
  const float* s1;
  const float* z1;
  const int8_t* q2;
  const float* s2;
  const float* z2;
  long long n;             // elements of the leaf
  long long rows;          // ceil(n / bs)
  long long dst_row;       // its first row in the output bucket
  long long bulk_rows;     // rows [0, bulk_rows) stream through the ring
  long long tile_begin;    // its first tile (a prefix sum over segments)
  long long direct_begin;  // its first direct row (likewise)
};
static_assert(sizeof(Segment) == 112, "segment_table writes 14 int64");

// The table travels as a kernel parameter (__grid_constant__, read in
// place from the parameter bank): no copy to device memory, so a step
// never waits on one.  256 segments fit Hopper's 32 KB of parameters.
constexpr int kMaxSegments = 256;
struct Table {
  Segment seg[kMaxSegments];
};

struct Out {
  float* p;
  int8_t* q1;
  float* s1;
  float* z1;
  int8_t* q2;
  float* s2;
  float* z2;
};

struct Scalars {
  float clip, lr, b1, b2, eps, wd, c1, c2, omb1, omb2;
};

template <int BS>
struct Shape {
  static constexpr int L = BS / 8 < 32 ? BS / 8 : 32;  // lanes a row
  static constexpr int W = 32 / L;                     // rows a warp
  static constexpr int C = BS / (4 * L);               // 4-value chunks a lane
  static constexpr int V = 4 * C;                      // values a lane
  static constexpr int R = kTileElems / BS;            // rows a tile
  // g, p (fp32), q1, q2 (int8), then s1, z1, s2, z2 (R floats each)
  static constexpr int kP = R * BS * 4, kQ1 = 2 * kP, kQ2 = kQ1 + R * BS;
  static constexpr int kS = kQ2 + R * BS;
  static constexpr int kStageBytes = kS + 16 * R;
};

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact int8 <-> float conversions on the FP32 pipe instead of the
// conversion unit, which runs at an eighth of its rate (16 lanes a clock an
// SM against 128): 1.5 * 2^23 + i holds i in its low mantissa bits for |i|
// < 2^22.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000

// byte j of packed as a signed int8, exactly as a float
__device__ __forceinline__ float byte_to_f32(int packed, int j) {
  const int q = static_cast<int8_t>(packed >> (8 * j));
  return __fsub_rn(__int_as_float(0x4B400000 + q), kMagic);
}

// an integral r in [-128, 127] as its int8 byte, in the low 8 bits
__device__ __forceinline__ int f32_to_byte(float r) {
  return __float_as_int(__fadd_rn(r, kMagic)) & 0xff;
}

__device__ __forceinline__ float dequant(int packed, int j, float s, float z,
                                         const Codec c) {
  const float d = __fmul_rn(s, __fadd_rn(byte_to_f32(packed, j), z));
  return c.sqrt_domain ? __fmul_rn(d, d) : d;
}

// quantize_int's block-wise row codec on one row held by a lane group;
// q gets the lane's payload bytes, four to an int
template <int BS>
__device__ __forceinline__ void requant(float (&x)[Shape<BS>::V],
                                        const Codec c,
                                        int (&q)[Shape<BS>::C], float& scale,
                                        float& zero) {
  using S = Shape<BS>;
  if (c.sqrt_domain) {
#pragma unroll
    for (int v = 0; v < S::V; ++v) x[v] = __fsqrt_rn(fmaxf(x[v], 0.0f));
  }
  if (c.symmetric) {
    float am = 0.0f;
#pragma unroll
    for (int v = 0; v < S::V; ++v) am = fmaxf(am, fabsf(x[v]));
    am = group_max<S::L>(am);
    scale = __fdiv_rn(fmaxf(am, 1e-12f), c.qmax);
    zero = 0.0f;
  } else {
    float mn = x[0], mx = x[0];
#pragma unroll
    for (int v = 1; v < S::V; ++v) {
      mn = fminf(mn, x[v]);
      mx = fmaxf(mx, x[v]);
    }
    mn = group_min<S::L>(mn);
    mx = group_max<S::L>(mx);
    scale = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), 1e-12f),
                      __fsub_rn(c.qmax, c.qmin));
    zero = __fsub_rn(rintf(__fdiv_rn(mn, scale)), c.qmin);
  }
#pragma unroll
  for (int ch = 0; ch < S::C; ++ch) {
    int packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r = __fsub_rn(rintf(__fdiv_rn(x[4 * ch + j], scale)), zero);
      r = fminf(fmaxf(r, c.qmin), c.qmax);
      packed |= f32_to_byte(r) << (8 * j);
    }
    q[ch] = packed;
  }
}

// One row's update on a lane group: g, p and the payloads in, p and the
// requantized payloads, scales and zeros out; adds the lane's (lr *
// update)^2 to sumsq
template <int BS>
struct Row {
  using S = Shape<BS>;
  float g[S::V], p[S::V];
  int q1[S::C], q2[S::C];
  float s1, z1, s2, z2;

  __device__ __forceinline__ void update(const Scalars& k, const Codec m1,
                                         const Codec m2, int wd_on,
                                         float& sumsq) {
    float d1[S::V], d2[S::V];
#pragma unroll
    for (int v = 0; v < S::V; ++v) {
      d1[v] = dequant(q1[v / 4], v % 4, s1, z1, m1);
      d2[v] = dequant(q2[v / 4], v % 4, s2, z2, m2);
    }
#pragma unroll
    for (int v = 0; v < S::V; ++v) {
      const float gg = __fmul_rn(g[v], k.clip);
      const float pv = p[v];
      d1[v] = __fadd_rn(__fmul_rn(k.b1, d1[v]), __fmul_rn(k.omb1, gg));
      d2[v] = __fadd_rn(__fmul_rn(k.b2, d2[v]),
                        __fmul_rn(k.omb2, __fmul_rn(gg, gg)));
      float upd = __fdiv_rn(
          __fdiv_rn(d1[v], k.c1),
          __fadd_rn(__fsqrt_rn(__fdiv_rn(d2[v], k.c2)), k.eps));
      if (wd_on) upd = __fadd_rn(upd, __fmul_rn(k.wd, pv));
      const float delta = __fmul_rn(k.lr, upd);
      p[v] = __fsub_rn(pv, delta);
      sumsq += delta * delta;
    }
    requant<BS>(d1, m1, q1, s1, z1);
    requant<BS>(d2, m2, q2, s2, z2);
  }
};

// the value index within its row of chunk ch of lane li
template <int BS>
__device__ __forceinline__ int col(int ch, int li) {
  return ch * 4 * Shape<BS>::L + 4 * li;
}

__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ sc) {
  Scalars k;
  k.clip = sc[0];
  k.lr = sc[1];
  k.b1 = sc[2];
  k.b2 = sc[3];
  k.eps = sc[4];
  k.wd = sc[5];
  k.c1 = sc[6];
  k.c2 = sc[7];
  k.omb1 = __fsub_rn(1.0f, k.b1);
  k.omb2 = __fsub_rn(1.0f, k.b2);
  return k;
}

// the segment of tile t, walking forward from s (tiles rise monotonically)
__device__ __forceinline__ int seek_tile(const Segment* __restrict__ segs,
                                         int nseg, int s, long long t) {
  while (s + 1 < nseg && segs[s + 1].tile_begin <= t) ++s;
  return s;
}

// the segment of direct row d: the last whose direct_begin <= d
__device__ __forceinline__ int seek_direct(const Segment* __restrict__ segs,
                                           int nseg, long long d) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (segs[mid].direct_begin <= d)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// the producer: one thread keeps every stage of the ring in flight
template <int BS>
__device__ void produce(const Segment* __restrict__ segs, int nseg,
                        int ntiles, uint32_t stages, uint32_t full0,
                        uint32_t empty0) {
  using S = Shape<BS>;
  int s = 0;
  for (int k = 0, t = blockIdx.x; t < ntiles; ++k, t += gridDim.x) {
    const int st = k % kStages;
    if (k >= kStages) mbar_wait(empty0 + 8 * st, ((k / kStages) - 1) & 1);
    s = seek_tile(segs, nseg, s, t);
    const Segment& sg = segs[s];
    const long long row0 = (t - sg.tile_begin) * S::R;
    const int nr = static_cast<int>(min(static_cast<long long>(S::R),
                                        sg.bulk_rows - row0));
    const uint32_t base = stages + st * S::kStageBytes;
    const uint32_t bar = full0 + 8 * st;
    const uint32_t fb = nr * BS * 4, qb = nr * BS, sb = nr * 4;
    const long long e0 = row0 * BS;
    mbar_expect_tx(bar, 2 * fb + 2 * qb + 4 * sb);
    bulk_load(base, sg.g + e0, fb, bar);
    bulk_load(base + S::kP, sg.p + e0, fb, bar);
    bulk_load(base + S::kQ1, sg.q1 + e0, qb, bar);
    bulk_load(base + S::kQ2, sg.q2 + e0, qb, bar);
    bulk_load(base + S::kS, sg.s1 + row0, sb, bar);
    bulk_load(base + S::kS + 4 * S::R, sg.z1 + row0, sb, bar);
    bulk_load(base + S::kS + 8 * S::R, sg.s2 + row0, sb, bar);
    bulk_load(base + S::kS + 12 * S::R, sg.z2 + row0, sb, bar);
  }
}

// store one updated row: p 16 bytes and each payload 4 bytes a lane (the
// output rows are 16-byte aligned: checked by the wrappers)
template <int BS>
__device__ __forceinline__ void store_vec(const Row<BS>& r, const Out& out,
                                          long long orow, int li) {
  using S = Shape<BS>;
#pragma unroll
  for (int ch = 0; ch < S::C; ++ch) {
    const long long o = orow * BS + col<BS>(ch, li);
    *reinterpret_cast<float4*>(out.p + o) =
        make_float4(r.p[4 * ch], r.p[4 * ch + 1], r.p[4 * ch + 2],
                    r.p[4 * ch + 3]);
    *reinterpret_cast<int*>(out.q1 + o) = r.q1[ch];
    *reinterpret_cast<int*>(out.q2 + o) = r.q2[ch];
  }
  if (li == 0) {
    out.s1[orow] = r.s1;
    out.z1[orow] = r.z1;
    out.s2[orow] = r.s2;
    out.z2[orow] = r.z2;
  }
}

// the consumers: the ring's tiles, then the direct rows
template <int BS>
__device__ float consume(const Segment* __restrict__ segs, int nseg,
                         int ntiles, long long ndirect, const Out& out,
                         const Scalars& k, const Codec m1, const Codec m2,
                         int wd_on, const unsigned char* stages,
                         uint32_t full0, uint32_t empty0, int warp,
                         int lane) {
  using S = Shape<BS>;
  const int li = lane % S::L, sub = lane / S::L;
  float sumsq = 0.0f;
  int s = 0;
  for (int kk = 0, t = blockIdx.x; t < ntiles; ++kk, t += gridDim.x) {
    const int st = kk % kStages;
    s = seek_tile(segs, nseg, s, t);
    const Segment& sg = segs[s];
    const long long row0 = (t - sg.tile_begin) * S::R;
    const int nr = static_cast<int>(min(static_cast<long long>(S::R),
                                        sg.bulk_rows - row0));
    const long long orow0 = sg.dst_row + row0;
    const unsigned char* base = stages + st * S::kStageBytes;
    const float* tg = reinterpret_cast<const float*>(base);
    const float* tp = reinterpret_cast<const float*>(base + S::kP);
    const int8_t* tq1 = reinterpret_cast<const int8_t*>(base + S::kQ1);
    const int8_t* tq2 = reinterpret_cast<const int8_t*>(base + S::kQ2);
    const float* ts = reinterpret_cast<const float*>(base + S::kS);
    mbar_wait(full0 + 8 * st, (kk / kStages) & 1);
    // nr is a multiple of 4; at bs = 32 a warp holds 8 rows, and a lane
    // group past nr computes on row 0 (its shuffles need every lane) and
    // stores nothing
    for (int grp = warp; grp * S::W < nr; grp += kConsumerWarps) {
      const bool valid = grp * S::W + sub < nr;
      const int r = valid ? grp * S::W + sub : 0;
      Row<BS> row;
#pragma unroll
      for (int ch = 0; ch < S::C; ++ch) {
        const int o = r * BS + col<BS>(ch, li);
        const float4 a = *reinterpret_cast<const float4*>(tg + o);
        const float4 b = *reinterpret_cast<const float4*>(tp + o);
        row.g[4 * ch] = a.x;
        row.g[4 * ch + 1] = a.y;
        row.g[4 * ch + 2] = a.z;
        row.g[4 * ch + 3] = a.w;
        row.p[4 * ch] = b.x;
        row.p[4 * ch + 1] = b.y;
        row.p[4 * ch + 2] = b.z;
        row.p[4 * ch + 3] = b.w;
        row.q1[ch] = *reinterpret_cast<const int*>(tq1 + o);
        row.q2[ch] = *reinterpret_cast<const int*>(tq2 + o);
      }
      row.s1 = ts[r];
      row.z1 = ts[S::R + r];
      row.s2 = ts[2 * S::R + r];
      row.z2 = ts[3 * S::R + r];
      float part = 0.0f;
      row.update(k, m1, m2, wd_on, part);
      if (!valid) continue;
      sumsq += part;
      store_vec<BS>(row, out, orow0 + r, li);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // direct rows: element loads and stores, any alignment; a lane group
  // past the end computes on zeros (its shuffles need every lane) and
  // stores nothing
  const long long units = (ndirect + S::W - 1) / S::W;
  for (long long u = static_cast<long long>(blockIdx.x) * kConsumerWarps +
                     warp;
       u < units; u += static_cast<long long>(gridDim.x) * kConsumerWarps) {
    const long long d = u * S::W + sub;
    const bool valid = d < ndirect;
    const Segment& sg = segs[valid ? seek_direct(segs, nseg, d) : 0];
    const long long r = sg.bulk_rows + (d - sg.direct_begin);
    Row<BS> row;
    float part = 0.0f;
#pragma unroll
    for (int ch = 0; ch < S::C; ++ch) {
      int p1 = 0, p2 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = r * BS + col<BS>(ch, li) + j;
        const bool in = valid && e < sg.n;
        row.g[4 * ch + j] = in ? sg.g[e] : 0.0f;
        row.p[4 * ch + j] = in ? sg.p[e] : 0.0f;
        if (valid) {
          p1 |= (static_cast<int>(sg.q1[e]) & 0xff) << (8 * j);
          p2 |= (static_cast<int>(sg.q2[e]) & 0xff) << (8 * j);
        }
      }
      row.q1[ch] = p1;
      row.q2[ch] = p2;
    }
    row.s1 = valid ? sg.s1[r] : 0.0f;
    row.z1 = valid ? sg.z1[r] : 0.0f;
    row.s2 = valid ? sg.s2[r] : 0.0f;
    row.z2 = valid ? sg.z2[r] : 0.0f;
    row.update(k, m1, m2, wd_on, part);
    if (!valid) continue;
    sumsq += part;
    const long long orow = sg.dst_row + r;
#pragma unroll
    for (int ch = 0; ch < S::C; ++ch) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long o = orow * BS + col<BS>(ch, li) + j;
        out.p[o] = row.p[4 * ch + j];
        out.q1[o] = static_cast<int8_t>(row.q1[ch] >> (8 * j));
        out.q2[o] = static_cast<int8_t>(row.q2[ch] >> (8 * j));
      }
    }
    if (li == 0) {
      out.s1[orow] = row.s1;
      out.z1[orow] = row.z1;
      out.s2[orow] = row.s2;
      out.z2[orow] = row.z2;
    }
  }
  return sumsq;
}

template <int BS>
__global__ void __launch_bounds__(kThreads, 3)
adamw_stream_kernel(const __grid_constant__ Table tab, int nseg, int ntiles,
                    long long ndirect, Out out, const float* __restrict__ sc,
                    float* __restrict__ partial, Codec m1, Codec m2,
                    int wd_on) {
  const Segment* segs = tab.seg;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_sums[kConsumerWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kStages;
  unsigned char* stages = smem + kBarBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    if (lane == 0)
      produce<BS>(segs, nseg, ntiles, smem_u32(stages), full0, empty0);
  } else {
    float sumsq = consume<BS>(segs, nseg, ntiles, ndirect, out,
                              load_scalars(sc), m1, m2, wd_on, stages,
                              full0, empty0, warp, lane);
    sumsq = warp_sum(sumsq);
    if (lane == 0) warp_sums[warp] = sumsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) t += warp_sums[w];
    partial[blockIdx.x] = t;
  }
}

template <int BS>
int launch(const Table& tab, int nseg, int ntiles, long long ndirect,
           int grid, const Out& out, const float* sc, float* partial,
           Codec m1, Codec m2, int wd_on, cudaStream_t stream) {
  constexpr int smem = kBarBytes + kStages * Shape<BS>::kStageBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      adamw_stream_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  adamw_stream_kernel<BS><<<grid, kThreads, smem, stream>>>(
      tab, nseg, ntiles, ndirect, out, sc, partial, m1, m2, wd_on);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: nseg <= 256 Segments (14 int64 each) in host memory, as
// kernels/opt_update.py:segment_table builds them; ntiles tiles of
// tile_rows = 2048 / bs rows and ndirect direct rows over them.  Out:
// p (fp32), q1, q2 (int8) of (rows, bs) and s1, z1, s2, z2 (fp32, rows),
// 16-byte aligned; sc (8) fp32 device scalars; partial (grid) fp32 out.
// bs in {32, 64, 128, 256}.  Codec: (qmin, qmax, symmetric, sqrt_domain)
// per moment.
extern "C" int repro_fused_adamw(const void* segs, int nseg, int ntiles,
                                 long long ndirect, int tile_rows, int grid,
                                 void* p, void* q1, void* s1, void* z1,
                                 void* q2, void* s2, void* z2,
                                 const void* sc, void* partial, int bs,
                                 int m1_qmin, int m1_qmax, int m1_sym,
                                 int m1_sqrt, int m2_qmin, int m2_qmax,
                                 int m2_sym, int m2_sqrt, int wd_on,
                                 void* stream) {
  const Codec m1{static_cast<float>(m1_qmin), static_cast<float>(m1_qmax),
                 m1_sym, m1_sqrt};
  const Codec m2{static_cast<float>(m2_qmin), static_cast<float>(m2_qmax),
                 m2_sym, m2_sqrt};
  if (bs <= 0 || tile_rows != kTileElems / bs || grid < 1 || nseg < 1 ||
      nseg > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab;
  memcpy(tab.seg, segs, sizeof(Segment) * nseg);
  const Out out{static_cast<float*>(p),  static_cast<int8_t*>(q1),
                static_cast<float*>(s1), static_cast<float*>(z1),
                static_cast<int8_t*>(q2), static_cast<float*>(s2),
                static_cast<float*>(z2)};
  const auto* k = static_cast<const float*>(sc);
  auto* part = static_cast<float*>(partial);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 32:
      return launch<32>(tab, nseg, ntiles, ndirect, grid, out, k, part, m1,
                        m2, wd_on, st);
    case 64:
      return launch<64>(tab, nseg, ntiles, ndirect, grid, out, k, part, m1,
                        m2, wd_on, st);
    case 128:
      return launch<128>(tab, nseg, ntiles, ndirect, grid, out, k, part, m1,
                         m2, wd_on, st);
    case 256:
      return launch<256>(tab, nseg, ntiles, ndirect, grid, out, k, part, m1,
                         m2, wd_on, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
