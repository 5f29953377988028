// Causal flash-attention forward over an int8 KV cache at the bf16 carrier,
// on Hopper's tensor cores (sm_90a: TMA, mbarriers, wgmma).
//
// Replaces: src/repro/kernels/flash_attn.py:flash_attention_fwd_q8 (its
// body is _flash_fwd_q8_kernel), the int8-KV prefill of the serving path,
// at the bf16 carrier.  The float32 carrier keeps flash_attn_q8.cu's
// CUDA-core body: TF32 drops 13 bits of every operand.
// q (B, Sq, H, hd) bf16; kq/vq (B, Skv, KH, hd) int8 payloads with ks/vs
// (B, Skv, KH, 1) fp32 per-(position, head) scales; GQA through kv head
// h / (H / KH), no repeat; hd in {32, 64, 128, 160, 256}; every tensor
// contiguous, q, kq and vq 16-byte aligned.
//
// What is computed, in the reference's rounding order (summed in another
// order): s = ((q * 1/sqrt(hd)) . kq) * g(ks) -- x = fl(q * scale) in fp32,
// the dot product, then one rounded multiply by the key's guarded scale --
// -1e30 where kpos > q_offset + qpos (causal) or kpos >= Skv; the online
// softmax (m from -1e30, l summed over the fp32 p), acc += fl(p * g(vs)) .
// vq with p * g(vs) kept in fp32 (the reference does not round it to the
// carrier) -- run as two streams, the keys 64t..64t+31 and 64t+32..64t+63
// of every tile t, merged at the end: m = max(m0, m1), l and acc each side
// scaled by exp(m_w - m) and added -- out = acc / max(l, 1e-30), cast to
// bf16 (or
// left in fp32 by the test-only entry, repro_flash_q8_sm90 with out_dtype
// 0).  Every product is exact in fp32: the int8 payloads are exact in bf16
// (|v| <= 128), x goes to the tensor cores as one bf16 term where it is
// exact (hd 64 and 256: a scale of 1/8 or 1/16 and bf16 q) and as three
// terms hi + mid + lo == x otherwise (sm90.cuh:split_q), and fl(p * g(vs))
// is split on the accumulator fragment into three bf16 terms that sum to
// it exactly (sm90.cuh:bf16_terms), each fed to its own wgmma.  So the
// tensor cores change only the order of the fp32 sums.
//
// Bound (the serving gate, B 4, Sq 256, Skv 1024, H = KH = 12, hd 64,
// causal): q and out (3.1 MB), the visible K/V rows once (0.8 MB of int8
// and their scales) -- 1.2 us at 3.35 TB/s -- against 1.6 M visible pairs
// of four bf16-exact products of 2 * hd FLOPs (q.k and three for p.v),
// 0.8 GFLOP, 0.8 us at 989 TFLOP/s: a few microseconds of work spread over
// 192 blocks of at most four key tiles each, so latency, not throughput,
// sets the time: the chain of each block's tiles, and in each tile the
// widening, the softmax and the three-term split on the CUDA cores.
// Design:
//  - one block per (64 query rows, head, batch), the causally heaviest q
//    blocks first (grid z runs backwards), of two warpgroups that share
//    each 64-key tile: warpgroup w takes its keys 32w..32w+31, with its own
//    online softmax (m, l, acc), and the two are combined once at the end
//    (split-KV inside the block), so each warp does half a tile's CUDA-core
//    work, and the registers leave room for two blocks an SM;
//  - Q by TMA through a 4-D map over (B, Sq, H, hd) (128-byte swizzle,
//    columns past hd zero-filled), split in place into its terms, shared;
//  - each warpgroup's own int8 K and V half-tiles (32 rows, half the bytes
//    of bf16) by TMA through 4-D maps over (B, Skv, KH, hd) into its own
//    3-stage mbarrier ring, issued by its first thread, so the warpgroups
//    never wait on each other; the scales by plain loads a tile ahead into
//    registers (their row stride, 4 * KH bytes, is no multiple of 16 for KH
//    in {1, 2}, which TMA needs);
//  - a warpgroup widens its half-tiles to bf16 (exact, with integer and
//    bf16x2 operations, widen2: int-to-float conversions share a pipe with
//    the softmax's exponentials) straight into the 128-byte-swizzled layout
//    wgmma reads from shared memory, K read K-major for S = Q K^T and V
//    MN-major for P V (the 16-bit transpose bit; the 8-bit types have
//    none), and refills the ring stage at once;
//  - S by wgmma m64n32k16 from shared memory, the softmax on the
//    accumulator fragment (compiled with and without the mask: diagonal and
//    ragged half-tiles only), fl(p * g(vs)) split into three bf16 A
//    fragments two values at a time on packed conversions, and O += the
//    three products by wgmma m64n64k16 (A from registers);
//  - at hd 256 (Gemma) the block holds one Q term (32 KB), two bf16 K/V
//    half-tile pairs (64 KB) and two int8 rings (96 KB): 198,272 bytes,
//    one block an SM; each warpgroup's O accumulator is 64 x 256 fp32
//    (128 registers a thread), and P V runs as four m64n64 chunks;
//  - at hd 160 (Zamba2's shared block) 1/sqrt(160) is no power of two, so
//    q takes three terms, padded to HDP = 192 (three 64-column chunks:
//    Q's columns 160-191 zero-filled by TMA, the bf16 K/V tiles' zeroed
//    once); three Q terms (72 KB), the bf16 half-tiles (48 KB) and the
//    rings of 160-byte int8 rows (72 KB) make the same 198,272 bytes; the
//    accumulator is 64 x 192 fp32 (96 registers a thread);
//  - key tiles past q_offset + a warpgroup's last query are skipped, so the
//    engine's 1024-row buffers are never read past the prompt; the combine
//    goes through shared memory, each output row is written once, no
//    atomics, so a launch repeats its bits.
// exp is __expf (ex2.approx on a log2e-scaled argument, a few ulp off
// expf's fp32 rounding); the reference's rounding order is kept elsewhere.
// Tried on the H100 (PERF.md; gate shape, queued): one warpgroup a
// block over whole 64-key tiles, 0.0162 ms; the same with the next tile
// widened under this tile's P V, 0.0171 ms; this design with int-to-float
// widening, 0.0156 ms (by parts, per half-tile: 0.96 us softmax and split,
// 0.68 us widening, 0.77 us waits, barriers and wgmma); a converter warp
// widening ahead of two consumer warpgroups into a bf16 ring, 0.0213 ms
// (0.0189 with widen2): the one warp could not keep up.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // key rows per tile
constexpr int kHK = 32;      // key rows per warpgroup of a tile
constexpr int kNWG = 2;      // warpgroups, one per half-tile
constexpr int kStages = 3;   // int8 K/V ring of a warpgroup
constexpr int kThreads = 128 * kNWG;

template <int HDP, int NQ>
struct Cfg {
  static constexpr int NC = HDP / 64;              // 64-column chunks
  static constexpr int Q_BYTES = NC * kBQ * 128;   // one Q term
  static constexpr int HB_BYTES = NC * kHK * 128;  // a bf16 K or V half-tile
  static constexpr int I8_BYTES = kHK * HDP;       // an int8 half-tile (max)
  static constexpr int RING = kStages * 2 * I8_BYTES;  // a warpgroup's ring
  // what the second warpgroup hands the first for the combine: acc, m, l
  static constexpr int STAGE_FLOATS = NC * 32 + 4;
  static constexpr int SMEM = NQ * Q_BYTES + kNWG * 2 * HB_BYTES +
                              kNWG * RING + kNWG * 2 * kHK * 4 + 1024 + 128;
  // registers (acc, S, the p terms) leave room for two blocks an SM at one
  // 64-column chunk
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
  static_assert(kNWG * RING >= STAGE_FLOATS * 128 * 4,
                "the rings hold the combine's staging");
  static_assert(SMEM <= kSmemMax, "shared memory over the block limit");
};

// two int8 values of w (the bytes that selector sel of __byte_perm places
// in the low byte of each 16-bit lane) as a bf16 pair, exactly, on the
// integer and bf16x2 pipes (no int-to-float conversion): for a byte B =
// r + 128 s (r its low seven bits, s its sign bit), bf16(128 + r) has the
// bits 0x4300 | r and bf16(128 + 128 s) the bits 0x4300 | (B & 0x80), and
// their difference, r - 128 s = the int8 value, is exact in bf16
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {
  const uint32_t x = __byte_perm(w, 0u, sel);
  const uint32_t mag = (x & 0x007f007fu) | 0x43004300u;
  const uint32_t off = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
              *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 values as 16 bf16 (exact), two 16-byte chunks
__device__ __forceinline__ void widen16(const int4 raw, uint4& lo, uint4& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  lo = make_uint4(widen2(w[0], 0x4140u), widen2(w[0], 0x4342u),
                  widen2(w[1], 0x4140u), widen2(w[1], 0x4342u));
  hi = make_uint4(widen2(w[2], 0x4140u), widen2(w[2], 0x4342u),
                  widen2(w[3], 0x4140u), widen2(w[3], 0x4342u));
}

// sm90.cuh:bf16_terms of (x0, x1), two at a time on packed conversions,
// straight into A-fragment registers: hi = bf16x2(x0, x1), mid = bf16x2 of
// the remainders, lo = bf16x2 of what is left; for a finite x (p * g(vs)
// is) the same terms, and a NaN stays one
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h));
  const float r1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(r0, __low2float(m)), __fsub_rn(r1, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------- kernel
template <int HDP, int NQ, typename OutT>
__global__ void __launch_bounds__(kThreads, Cfg<HDP, NQ>::MIN_BLOCKS)
flash_q8_sm90(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ ks, const float* __restrict__ vs,
              OutT* __restrict__ out, int Sq, int Skv, int H, int KH, int HD,
              float scale, int causal, int q_offset) {
  using C = Cfg<HDP, NQ>;
  constexpr int NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c4 = lane % 4;
  uint8_t* qs = smem;                                    // NQ x [NC][64][64]
  uint8_t* kb = qs + NQ * C::Q_BYTES + wg * 2 * C::HB_BYTES;  // [NC][32][64]
  uint8_t* vb = kb + C::HB_BYTES;                        // [NC][32][64]
  uint8_t* rings = qs + NQ * C::Q_BYTES + kNWG * 2 * C::HB_BYTES;
  uint8_t* ring = rings + wg * C::RING;                  // kStages x (K, V)
  float* ksc = reinterpret_cast<float*>(rings + kNWG * C::RING) + wg * 2 * kHK;
  float* vsc = ksc + kHK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<float*>(rings + kNWG * C::RING) + kNWG * 2 * kHK);
  auto bar_q = [&] { return smem_u32(bars); };
  auto bar_full = [&](int s) { return smem_u32(bars + 1 + wg * kStages + s); };
  const int half_i8 = kHK * HD;  // bytes of one int8 half-tile (rows of HD)
  auto k_i8 = [&](int s) { return ring + s * 2 * C::I8_BYTES; };
  auto v_i8 = [&](int s) { return ring + s * 2 * C::I8_BYTES + C::I8_BYTES; };
  // the warpgroup's own barrier (0 is the block's)
  auto wg_sync = [&] {
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  };

  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int k_off = kHK * wg;  // this warpgroup's keys in each tile
  // this warpgroup's live tiles: keys below Skv and, under the causal mask,
  // at most the block's last query position
  int n_tiles = Skv > k_off ? (Skv - k_off + kBK - 1) / kBK : 0;
  if (causal) {
    const int last_q = q_offset + min(q0 + kBQ, Sq) - 1;
    n_tiles = last_q >= k_off ? min(n_tiles, (last_q - k_off) / kBK + 1) : 0;
  }

  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_expect_tx(bar_full(s), 2 * half_i8);
    tma_load_4d(smem_u32(k_i8(s)), map_k, bar_full(s), 0, kh,
                t * kBK + k_off, b);
    tma_load_4d(smem_u32(v_i8(s)), map_v, bar_full(s), 0, kh,
                t * kBK + k_off, b);
  };
  // the guarded scales of this warpgroup's key tid of tile t (threads below
  // kHK), loaded a tile ahead into registers; 1 past Skv
  float nks = 1.0f, nvs = 1.0f;
  auto fetch_scales = [&](int t) {
    const int key = t * kBK + k_off + tid;
    nks = nvs = 1.0f;
    if (tid < kHK && key < Skv) {
      const size_t at = (static_cast<size_t>(b) * Skv + key) * KH + kh;
      nks = scale_guard(ks[at]);
      nvs = scale_guard(vs[at]);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q(), 1);
    for (int s = 0; s < kNWG * kStages; ++s)
      mbar_init(smem_u32(bars + 1 + s), 1);
    mbar_fence_init();
  }
  // head dims below HDP: the bf16 tiles' columns past HD stay zero (Q's
  // are zero-filled by TMA), so the extra k-steps add exact zeros
  if (HD < HDP)
    for (int i = threadIdx.x; i < kNWG * 2 * C::HB_BYTES / 16; i += kThreads)
      reinterpret_cast<uint4*>(qs + NQ * C::Q_BYTES)[i] =
          make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q(), C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_4d(smem_u32(qs + c * kBQ * 128), &tq, bar_q(), 64 * c, h, q0,
                  b);
  }
  if (tid == 0)
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  fetch_scales(0);

  // q scaled (and split) in place by the whole block
  mbar_wait(bar_q(), 0);
  for (int i = threadIdx.x; i < NC * kBQ * 8; i += kThreads)
    split_q<NQ>(qs, C::Q_BYTES, i * 16, scale);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  const int row0 = 16 * warp + g;  // and row0 + 8, in the block
  const int qpos[2] = {q_offset + q0 + row0, q_offset + q0 + row0 + 8};
  const uint32_t q_base = smem_u32(qs), k_base = smem_u32(kb);
  const uint32_t v_base = smem_u32(vb);
  float sc[kHK / 2];
  uint32_t pa[3][kHK / 16][4];

  // the softmax of a half-tile on the fragment (sc: S, then p): the K
  // scale, the mask, the running max, p = exp(s - m), l, acc *= alpha, and
  // the three bf16 terms of fl(p * g(vs)) into P's A fragments.  Compiled
  // with and without the mask, so that the half-tiles that need none run no
  // per-key test.
  auto softmax_body = [&](auto masked_tag, int k0) {
    constexpr bool masked = decltype(masked_tag)::value;
    float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c4 + e, key = k0 + col;
          float& v = sc[4 * j + 2 * i + e];
          v = __fmul_rn(v, ksc[col]);
          if (masked && (key >= Skv || (causal && key > qpos[i]))) v = -1e30f;
          mx[i] = fmaxf(mx[i], v);
        }
    float m_new[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
    }
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[4 * j + 2 * i + e];
          v = __expf(v - m_new[i]);
        }
    if constexpr (masked) {
#pragma unroll
      for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * c4 + e >= Skv)
            sc[4 * j + e] = sc[4 * j + 2 + e] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) psum[i] += sc[4 * j + 2 * i + e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      const float alpha = __expf(m[i] - m_new[i]);
      l[i] = alpha * l[i] + psum[i];
      m[i] = m_new[i];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[c][4 * j + 2 * i] *= alpha;
          acc[c][4 * j + 2 * i + 1] *= alpha;
        }
    }
    // k16 slice kk of P's A fragment holds S columns 16kk..16kk+15:
    // registers pack(x[8kk + 2r], x[8kk + 2r + 1]), x = fl(p * g(vs))
#pragma unroll
    for (int kk = 0; kk < kHK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = 8 * kk + 2 * r;
        const int col = 8 * (idx / 4) + 2 * c4;  // both of the pair's keys
        split_pair(__fmul_rn(sc[idx], vsc[col]),
                   __fmul_rn(sc[idx + 1], vsc[col + 1]), pa[0][kk][r],
                   pa[1][kk][r], pa[2][kk][r]);
      }
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, k0 = t * kBK + k_off;
    mbar_wait(bar_full(s), (t / kStages) & 1);
    // every wgmma of the half-tile before has read kb and vb
    wg_sync();
    // widen the int8 half-tiles into the swizzled bf16 layout: a 16-byte
    // unit (16 values of one row) becomes two 16-byte chunks, chunk j of a
    // 128-byte row stored at chunk j ^ (row % 8)
    const int units = HD / 16;
    for (int i = tid; i < kHK * units; i += 128) {
      const int row = i / units, col = 16 * (i % units);
      const int c = col / 64, j0 = (col % 64) / 8;
      const uint32_t at = c * kHK * 128 + row * 128;
      const uint32_t o0 = at + ((j0 ^ (row & 7)) * 16);
      const uint32_t o1 = at + (((j0 + 1) ^ (row & 7)) * 16);
      uint4 lo, hi;
      widen16(*reinterpret_cast<const int4*>(k_i8(s) + row * HD + col), lo,
              hi);
      *reinterpret_cast<uint4*>(kb + o0) = lo;
      *reinterpret_cast<uint4*>(kb + o1) = hi;
      widen16(*reinterpret_cast<const int4*>(v_i8(s) + row * HD + col), lo,
              hi);
      *reinterpret_cast<uint4*>(vb + o0) = lo;
      *reinterpret_cast<uint4*>(vb + o1) = hi;
    }
    if (tid < kHK) {
      ksc[tid] = nks;
      vsc[tid] = nvs;
    }
    if (t + 1 < n_tiles) fetch_scales(t + 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_sync();
    // the ring stage is widened: load this warpgroup's tile kStages on
    if (tid == 0 && t + kStages < n_tiles) load_kv(t + kStages);

    // S = Q K^T over HDP / 16 k-steps, every Q term into one accumulator
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < HDP / 16; ++k16) {
      const uint32_t col = k16 / 4, within = (k16 % 4) * 32;
      const uint64_t bd = gmma_desc(k_base + col * kHK * 128 + within, 16,
                                    1024);
      const uint32_t a = q_base + col * kBQ * 128 + within;
#pragma unroll
      for (int term = 0; term < NQ; ++term)
        wgmma_ss<kHK>(sc, gmma_desc(a + term * C::Q_BYTES, 16, 1024), bd,
                      k16 + term > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (k0 + kHK > Skv || (causal && k0 + kHK - 1 > q_offset + q0))
      softmax_body(std::true_type(), k0);
    else
      softmax_body(std::false_type(), k0);

    // O += sum over the three terms of P_term V, per 64 output columns
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < kHK / 16; ++kk)
#pragma unroll
        for (int term = 0; term < 3; ++term)
          wgmma_rs_n64(acc[c], pa[term][kk],
                       gmma_desc(v_base + c * kHK * 128 + kk * 2048,
                                 kHK * 128, 1024),
                       1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
  }

  // the combine: the second warpgroup hands its (acc, m, l) to the first
  // through the rings (idle now: every load was consumed), element r of
  // thread tid at [r][tid]; m = max(m0, m1), each side scaled by exp(m_w -
  // m), out = acc / max(l, 1e-30), each row written once
  float* stage = reinterpret_cast<float*>(rings);
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) stage[(32 * c + i) * 128 + tid] = acc[c][i];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      stage[(32 * NC + i) * 128 + tid] = m[i];
      stage[(32 * NC + 2 + i) * 128 + tid] = l[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    const float m1 = stage[(32 * NC + i) * 128 + tid];
    const float l1 = stage[(32 * NC + 2 + i) * 128 + tid];
    const float mm = fmaxf(m[i], m1);
    const float a0 = __expf(m[i] - mm), a1 = __expf(m1 - mm);
    const float lf = floor_l(a0 * l[i] + a1 * l1);
    if (qi >= Sq) continue;
    OutT* orow = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * c4;
        if (col >= HD) continue;
        const int e0 = 4 * j + 2 * i;
        const float o0 =
            (a0 * acc[c][e0] + a1 * stage[(32 * c + e0) * 128 + tid]) / lf;
        const float o1 = (a0 * acc[c][e0 + 1] +
                          a1 * stage[(32 * c + e0 + 1) * 128 + tid]) / lf;
        if constexpr (std::is_same<OutT, float>::value)
          *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o0, o1);
      }
  }
}

// ----------------------------------------------------------------- host
// a (B, S, heads, HD) tensor as a 4-D TMA map, boxes of box_cols x 1 head x
// rows x 1: bf16 with the 128-byte swizzle (q), or int8 unswizzled (kq, vq);
// zero fill past S and past HD
bool make_map_4d(CUtensorMap* map, const void* base, bool is_bf16, int B,
                 int S, int heads, int HD, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = is_bf16 ? 2 : 1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * es, heads * HD * es,
                                 static_cast<cuuint64_t>(S) * heads * HD * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(is_bf16 ? 64 : HD), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int NQ, typename OutT>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, void* out, int B, int Sq, int Skv, int H, int KH,
           int HD, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  using C = Cfg<HDP, NQ>;
  CUtensorMap tq, tk, tv;
  if (!make_map_4d(&tq, q, true, B, Sq, H, HD, kBQ) ||
      !make_map_4d(&tk, kq, false, B, Skv, KH, HD, kHK) ||
      !make_map_4d(&tv, vq, false, B, Skv, KH, HD, kHK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_q8_sm90<HDP, NQ, OutT>;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (e) return e;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<OutT*>(out), Sq, Skv, H, KH, HD, scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int by_hd(const void* q, const void* kq, const void* ks, const void* vq,
          const void* vs, void* out, int B, int Sq, int Skv, int H, int KH,
          int HD, float scale, int causal, int q_offset, cudaStream_t st) {
  // a power-of-two scale (hd 64) makes q * scale exact in bf16: one Q term;
  // any other takes three (exact for every scale)
  int ex;
  const bool pow2 = frexpf(scale, &ex) == 0.5f;
#define REPRO_LAUNCH(HDP, NQ)                                              \
  launch<HDP, NQ, OutT>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, HD,     \
                        scale, causal, q_offset, st)
  switch (HD) {
    case 32: return REPRO_LAUNCH(64, 3);
    case 64: return pow2 ? REPRO_LAUNCH(64, 1) : REPRO_LAUNCH(64, 3);
    case 128: return REPRO_LAUNCH(128, 3);
    // hd 160 pads to three 64-column chunks; its scale takes three terms
    case 160: return REPRO_LAUNCH(192, 3);
    // three Q terms would need 263,808 bytes of shared memory at hd 256,
    // over the block's limit; its scale of 1/16 takes one
    case 256: return pow2 ? REPRO_LAUNCH(256, 1)
                          : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (B, Sq, H, HD) bf16, kq/vq (B, Skv, KH, HD) int8, ks/vs (B, Skv, KH, 1)
// f32, all contiguous (q, kq, vq 16-byte aligned) -> out (B, Sq, H, HD):
// bf16 (out_dtype 1, the kernel of the serving path) or f32 before the
// cast (out_dtype 0, for the tests).  HD in {32, 64, 128, 160, 256} (256 with a
// power-of-two scale only), H % KH == 0.
extern "C" int repro_flash_q8_sm90(const void* q, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, void* out, int B, int Sq,
                                   int Skv, int H, int KH, int HD,
                                   float scale, int causal, int q_offset,
                                   int out_dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KH < 1 || H % KH || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, kq, vq};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBFloat16)
    return by_hd<bf16>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, HD, scale,
                       causal, q_offset, st);
  if (out_dtype == kFloat32)
    return by_hd<float>(q, kq, ks, vq, vs, out, B, Sq, Skv, H, KH, HD, scale,
                        causal, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
