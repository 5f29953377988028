// Flash attention backward over fp K/V at the bf16 carrier, on Hopper's
// tensor cores (sm_90a: TMA, mbarriers, wgmma, setmaxnreg): the parts that
// the two libraries share -- flash_bwd_sm90.cu (head dims 16-128) and
// flash_bwd_sm90_wide.cu (144-256).
//
// Replaces: src/repro/kernels/flash_attn.py:_fa_bwd -- its dK/dV
// pallas_call (#9, _flash_bwd_dkdv_kernel) and its dQ pallas_call (#10,
// _flash_bwd_dq_kernel).  The float32 carrier keeps flash_attn.cu's
// CUDA-core kernels: TF32 drops 13 bits of every operand.
// Layout (BH, S, d), each tensor contiguous and 16-byte aligned, q/k/v/dO
// and the gradients bfloat16, lse and delta (BH, Sq) float32; d a multiple
// of 16 in [16, 256].
//
// What is computed, in the reference's rounding order (flash_attn.cu's
// backward, summed in another order): s = fl(scale * (q . k)) (the scale
// applied last, __fmul_rn), -1e30 where kpos > q_offset + qpos, p =
// expf(s - lse) in fp32, dv += p^T dO, ds = p * (dO . v - delta) * scale,
// dk += ds^T q (q unscaled), dq += ds k; dq, dk and dv rounded once to
// bf16.  p and ds stay fp32: each is split on the accumulator fragment into
// three bf16 terms hi + mid + lo == x (sm90.cuh:bf16_terms, exact while
// |x| >= 2^-110; a NaN or inf stays in hi), and each term goes straight
// into the register A fragment of a wgmma.  So p^T dO, ds^T q and ds k are
// three wgmma each, and, as q . k and dO . v (bf16 x bf16), every product
// is exact in fp32: the tensor cores change only the order of the fp32
// sums.  Rows past Sq and keys past Skv get p = 0; a NaN in q reaches its
// dq row and every dk / dv row whose tile it meets.
//
// Common design: persistent blocks, one per SM, two consumer warpgroups
// and one producer warpgroup that gives its registers away (setmaxnreg 24
// / 240); 128-byte swizzled tiles (3-D maps over (BH, S, d), rows past S
// and columns past d zero-filled by the hardware, so head dim 160 runs on
// 192 columns: three 64-column chunks, ten k16 slices of the contraction
// over d); nothing of S, P or dS touches shared or global memory; no
// atomics, each output row has one writer, so a second launch repeats the
// bits.  The tensor cores' fp32 sums do not round to nearest
// (flash_fwd_sm90.cu), and over a long chain their error grows with the
// running sum: each tile's dV, dK or dQ products (per 64-column chunk)
// land in zeroed registers and are added to the running sums with
// __fadd_rn (add_tile): chained over every tile, dk and dv came within
// 1.2x of phase 13's rel L2 limit; per tile they stay 3.2x under it, level
// with an fp32-ordered plain sum (PERF.md, H100 80GB HBM3, 700 W).
//
// #10 (flash_bwd_dq_sm90, both libraries): work item = 128 query rows of
// one head (64 per consumer warpgroup), the causally heaviest first.  Q and
// dO of the item (two buffers where they fit) and K/V tiles of BK keys in a
// ring, by TMA; lse and delta per row in registers.  Per tile S = Q K^T
// and dP = dO V^T, ds on the fragment, dQ += sum_terms dS K (B = K read
// MN-major).  Up to d = 128: BK = 64, and the next tile's S and dP go to
// the tensor cores with this tile's dQ.  Above: dQ alone takes d / 2 = 96
// or 128 registers a thread, so BK = 32 (S, dP and the three ds terms take
// 56 registers instead of 112), the overlap kept at 192 columns (216
// registers live) and dropped at 256 (248 would be live: the next tile's
// S and dP start after dQ's last chunk; with the overlap it spilled and
// ran slower, tools/flash_bwd_overlap.py).  A warpgroup stops at the last
// key tile its last query sees.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerRegs = 240;
constexpr int kNWG = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kNWG + 1);

// ---------------------------------------------------------- shared parts
// the three bf16 terms of an m64 x nN fp32 fragment x as the register A
// fragments of N / 16 k16 slices: a[term][kk]
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 2],
                                           uint32_t (&a)[3][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float h0, m0, l0, h1, m1, l1;
      bf16_terms(x[8 * kk + 2 * r], h0, m0, l0);
      bf16_terms(x[8 * kk + 2 * r + 1], h1, m1, l1);
      a[0][kk][r] = pack_bf16(h0, h1);
      a[1][kk][r] = pack_bf16(m0, m1);
      a[2][kk][r] = pack_bf16(l0, l1);
    }
}

// t = sum_terms A[term] . B over K = 16 * KS rows of a [NC][R][64]
// swizzled tile at `b` (B read MN-major: N = the 64 columns of chunk c),
// into zeroed registers (the first product does not accumulate)
template <int KS, int R>
__device__ __forceinline__ void issue_chunk(float (&t)[32],
                                            const uint32_t (&a)[3][KS][4],
                                            uint32_t b, int c) {
  fence_regs(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int term = 0; term < 3; ++term)
      wgmma_rs_n64(t, a[term][kk],
                   gmma_desc(b + c * R * 128 + kk * 2048, R * 128, 1024),
                   kk + term > 0);
}

// dst (this warpgroup's 64 rows, from `row0`) = acc rounded to bf16, rows
// below `rows`, columns below HD
template <int NC>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[NC][32],
                                           int row0, int rows, int HD) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r = row0 + 16 * (tid / 32) + lane / 4, c4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= rows) continue;
    bf16* out = dst + static_cast<size_t>(r + 8 * i) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * c4;
        if (col < HD)
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __halves2bfloat162(
              __float2bfloat16_rn(acc[c][4 * j + 2 * i]),
              __float2bfloat16_rn(acc[c][4 * j + 2 * i + 1]));
      }
  }
}

__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// x, as a value the compiler cannot see through.  S's (S^T's) A operand
// is the item's Q (K) tile, the same for every tile of the loop: made from
// an opaque base at each call, its d / 16 descriptors are computed where
// the wgmma reads them, not hoisted out of the loop and held in registers
// (2 each, per operand: 32-64 at d > 128, which ptxas spilled)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// -------------------------------------------------- #9's producer side
// #9's shared memory for a config C (BKB key rows an item, BQ query rows a
// tile, NC chunks, KVBUF item buffers, NS ring stages): KVBUF x (K, V)
// [NC][BKB][64], NS x (Q, dO) [NC][BQ][64], NS x (lse, delta) rows of BQ,
// then the mbarriers
template <class C>
struct DkdvSmem {
  uint8_t* kvs;
  uint8_t* ts;
  float* rows;
  uint64_t* bars;
  __device__ explicit DkdvSmem(uint8_t* smem)
      : kvs(smem),
        ts(smem + C::KVBUF * 2 * C::KV_BYTES),
        rows(reinterpret_cast<float*>(ts + C::NS * 2 * C::T_BYTES)),
        bars(reinterpret_cast<uint64_t*>(rows + C::NS * 2 * C::BQ)) {}
  __device__ uint32_t kv(int b) const { return smem_u32(bars + b); }
  __device__ uint32_t kvfree(int b) const { return smem_u32(bars + 2 + b); }
  __device__ uint32_t full(int s) const { return smem_u32(bars + 4 + s); }
  __device__ uint32_t empty(int s) const {
    return smem_u32(bars + 4 + C::NS + s);
  }
  // the first query tile that sees key row kr
  __device__ int first_tile(int kr, int causal, int q_offset) const {
    return causal ? max(0, kr - q_offset) / C::BQ : 0;
  }
  __device__ void init() const {
    for (int b = 0; b < C::KVBUF; ++b) {
      mbar_init(kv(b), 1);
      mbar_init(kvfree(b), 4 * kNWG);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread and the rows warp
      mbar_init(empty(s), 4 * kNWG);
    }
    mbar_fence_init();
  }
};

// #9's producer warpgroup.  Work item w: key block w / BH of head w % BH,
// so the key blocks that see the most query tiles go first; a block takes
// items blockIdx.x, + gridDim.x, ...  Warp 0 (one thread) loads K and V
// once per item and streams the (Q, dO) tiles through the ring by TMA;
// warp 1 copies each tile's lse and delta rows beside them (0 past Sq).
template <class C>
__device__ __forceinline__ void dkdv_produce(
    const DkdvSmem<C>& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, int BH,
    int Sq, int Skv, int causal, int q_offset) {
  constexpr int BQ = C::BQ, BKB = C::BKB, NC = C::NC, NS = C::NS;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
  const int n_items = BH * ((Skv + BKB - 1) / BKB);
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int pwarp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (pwarp == 0 && lane == 0) {
    int it = 0;
    for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
      const int bh = w % BH, k0 = (w / BH) * BKB, b = k % C::KVBUF;
      if (k >= C::KVBUF) mbar_wait(sm.kvfree(b), ((k / C::KVBUF) - 1) & 1);
      mbar_expect_tx(sm.kv(b), 2 * C::KV_BYTES);
      uint8_t* kb = sm.kvs + b * 2 * C::KV_BYTES;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(smem_u32(kb + c * BKB * 128), tk, sm.kv(b), 64 * c, k0,
                    bh);
        tma_load_3d(smem_u32(kb + C::KV_BYTES + c * BKB * 128), tv, sm.kv(b),
                    64 * c, k0, bh);
      }
      for (int t = sm.first_tile(k0, causal, q_offset); t < n_qt;
           ++t, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(sm.empty(s), ((it / NS) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * C::T_BYTES);
        uint8_t* tb = sm.ts + s * 2 * C::T_BYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(smem_u32(tb + c * BQ * 128), tq, sm.full(s), 64 * c,
                      t * BQ, bh);
          tma_load_3d(smem_u32(tb + C::T_BYTES + c * BQ * 128), tdo,
                      sm.full(s), 64 * c, t * BQ, bh);
        }
      }
    }
  } else if (pwarp == 1) {
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int bh = w % BH, k0 = (w / BH) * BKB;
      for (int t = sm.first_tile(k0, causal, q_offset); t < n_qt;
           ++t, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(sm.empty(s), ((it / NS) & 1) ^ 1);
        float* r = sm.rows + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int qi = t * BQ + i;
          const size_t at = static_cast<size_t>(bh) * Sq + qi;
          r[i] = qi < Sq ? lse[at] : 0.0f;
          r[BQ + i] = qi < Sq ? delta[at] : 0.0f;
        }
        mbar_arrive(sm.full(s));
      }
    }
  }
}

// #9's tiles and shared memory plan: NC_ 64-column chunks, BKB_ key rows
// an item, BQ_ query rows a tile; KVBUF item buffers where two fit beside
// a 2-stage ring, then as many ring stages (up to 8) as fit
template <int NC_, int BKB_, int BQ_>
struct DkdvPlan {
  static constexpr int NC = NC_, BKB = BKB_, BQ = BQ_;
  static constexpr int KV_BYTES = NC * BKB * 128;  // the item's K (or V)
  static constexpr int T_BYTES = NC * BQ * 128;    // one Q (or dO) tile
  static constexpr int ROW_BYTES = 2 * BQ * 4;     // its lse, delta rows
  static constexpr int KVBUF =
      4 * KV_BYTES + 2 * (2 * T_BYTES + ROW_BYTES) + 2048 <= kSmemMax ? 2
                                                                       : 1;
  static constexpr int NS_FIT = (kSmemMax - 2048 - KVBUF * 2 * KV_BYTES) /
                                (2 * T_BYTES + ROW_BYTES);
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;  // ring stages
  static constexpr int SMEM =
      KVBUF * 2 * KV_BYTES + NS * (2 * T_BYTES + ROW_BYTES) + 1024 + 256;
  static_assert(NS >= 2, "shared memory holds no 2-stage ring");
  static_assert(SMEM <= kSmemMax && SMEM >= 122880,
                "one block an SM (setmaxnreg's budget is the SM's)");
};

// ----------------------------------------------------------------- #10: dQ
template <int HDP>
struct DqCfg {
  static constexpr int BQ = 64 * kNWG;             // query rows per item
  static constexpr int BK = HDP <= 128 ? 64 : 32;  // key rows per tile
  static constexpr int NC = HDP / 64;
  // the next tile's S and dP issued with dQ's last chunk (the registers)
  static constexpr bool OVERLAP = HDP <= 192;
  static constexpr int Q_BYTES = NC * BQ * 128;    // the item's Q (or dO)
  static constexpr int KV_BYTES = NC * BK * 128;   // one K (or V) tile
  static constexpr int QBUF =
      4 * Q_BYTES + 4 * KV_BYTES + 2048 <= kSmemMax ? 2 : 1;
  static constexpr int NS_FIT =
      (kSmemMax - 2048 - QBUF * 2 * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;
  static constexpr int SMEM = QBUF * 2 * Q_BYTES + 2 * NS * KV_BYTES + 1024 + 256;
  static_assert(NS >= 2, "shared memory holds no 2-stage ring");
  static_assert(SMEM <= kSmemMax && SMEM >= 122880,
                "one block an SM (setmaxnreg's budget is the SM's)");
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int BH, int Sq, int Skv, int HD, float scale, int causal,
                  int q_offset) {
  using C = DqCfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, NC = C::NC, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;  // QBUF x (Q, dO) x [NC][BQ][64] bf16
  uint8_t* ks = qs + C::QBUF * 2 * C::Q_BYTES;  // NS x [NC][BK][64]
  uint8_t* vs = ks + NS * C::KV_BYTES;          // NS x [NC][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + NS * C::KV_BYTES);
  auto bar_q = [&](int b) { return smem_u32(bars + b); };
  auto bar_qfree = [&](int b) { return smem_u32(bars + 2 + b); };
  auto bar_full = [&](int s) { return smem_u32(bars + 4 + s); };
  auto bar_empty = [&](int s) { return smem_u32(bars + 4 + NS + s); };

  // work item w: q block nqb - 1 - w / BH of head w % BH, the heaviest
  // causal q blocks first; the block's last query bounds its key tiles
  const int nqb = (Sq + BQ - 1) / BQ, n_items = BH * nqb;
  auto item_q0 = [&](int w) { return (nqb - 1 - w / BH) * BQ; };
  auto tiles_to = [&](int last_q) {  // key tiles up to query row last_q
    const int n = (Skv + BK - 1) / BK;
    return causal ? min(n, (q_offset + last_q) / BK + 1) : n;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < C::QBUF; ++b) {
      mbar_init(bar_q(b), 1);
      mbar_init(bar_qfree(b), 4 * kNWG);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4 * kNWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kNWG) {
    // -------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kNWG * 128) {
      int it = 0;
      for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
        const int bh = w % BH, q0 = item_q0(w), b = k % C::QBUF;
        const int n_tiles = tiles_to(min(q0 + BQ, Sq) - 1);
        if (k >= C::QBUF) mbar_wait(bar_qfree(b), ((k / C::QBUF) - 1) & 1);
        mbar_expect_tx(bar_q(b), 2 * C::Q_BYTES);
        uint8_t* qb = qs + b * 2 * C::Q_BYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(smem_u32(qb + c * BQ * 128), &tq, bar_q(b), 64 * c, q0,
                      bh);
          tma_load_3d(smem_u32(qb + C::Q_BYTES + c * BQ * 128), &tdo,
                      bar_q(b), 64 * c, q0, bh);
        }
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % NS;
          if (it >= NS) mbar_wait(bar_empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(bar_full(s), 2 * C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_3d(smem_u32(ks + s * C::KV_BYTES + c * BK * 128), &tk,
                        bar_full(s), 64 * c, t * BK, bh);
            tma_load_3d(smem_u32(vs + s * C::KV_BYTES + c * BK * 128), &tv,
                        bar_full(s), 64 * c, t * BK, bh);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // and row0 + 8, in the item
    int it0 = 0;  // key tiles consumed by this block before this item
    for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
      const int bh = w % BH, q0 = item_q0(w), qb = k % C::QBUF;
      const int n_tiles = tiles_to(min(q0 + BQ, Sq) - 1);
      // this warpgroup's live tiles: none past Sq; under the causal mask,
      // those up to its own last query
      const int my_tiles = q0 + 64 * wg >= Sq
                               ? 0
                               : tiles_to(min(q0 + 64 * (wg + 1), Sq) - 1);
      auto stage = [&](int t) { return (it0 + t) % NS; };
      auto phase = [&](int t) { return ((it0 + t) / NS) & 1; };
      float lr[2], dr[2];
      int qpos[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 8 * i;
        const size_t at = static_cast<size_t>(bh) * Sq + qi;
        lr[i] = qi < Sq ? lse[at] : 0.0f;
        dr[i] = qi < Sq ? delta[at] : 0.0f;
        qpos[i] = q_offset + qi;
      }

      float adq[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) adq[c][i] = 0.0f;
      mbar_wait(bar_q(qb), (k / C::QBUF) & 1);
      const uint32_t q_base =
          smem_u32(qs + qb * 2 * C::Q_BYTES) + wg * 64 * 128;
      const uint32_t do_base = q_base + C::Q_BYTES;

      float sacc[BK / 2], pacc[BK / 2];
      uint32_t dsa[3][BK / 16][4];
      // S = Q K^T and dP = dO V^T of the tile in stage st
      auto issue_sdp = [&](int st) {
        const uint32_t k_s = smem_u32(ks + st * C::KV_BYTES);
        const uint32_t v_s = smem_u32(vs + st * C::KV_BYTES);
        const uint32_t qa0 = opaque(q_base), da0 = opaque(do_base);
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t col = kk / 4, within = (kk % 4) * 32;
          const uint32_t qa = col * BQ * 128 + within;
          const uint32_t kb = col * BK * 128 + within;
          wgmma_ss<BK>(sacc, gmma_desc(qa0 + qa, 16, 1024),
                       gmma_desc(k_s + kb, 16, 1024), kk > 0);
          wgmma_ss<BK>(pacc, gmma_desc(da0 + qa, 16, 1024),
                       gmma_desc(v_s + kb, 16, 1024), kk > 0);
        }
      };
      // the tile in stage st to the tensor cores and back
      auto sdp = [&](int st) {
        issue_sdp(st);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
      };
      // ds into pacc; lse and delta by row (query)
      auto grads_body = [&](auto masked_tag, int t) {
        constexpr bool masked = decltype(masked_tag)::value;
        const int t0 = t * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              const int key = t0 + 8 * j + 2 * c4 + e;
              float s = __fmul_rn(scale, sacc[x]);
              if (masked && causal && key > qpos[i]) s = -1e30f;
              float p = expf(s - lr[i]);
              if (masked && key >= Skv) p = 0.0f;
              pacc[x] = p * (pacc[x] - dr[i]) * scale;
            }
      };
      auto grads = [&](int t) {
        const int t0 = t * BK;
        if ((causal && t0 + BK - 1 > q_offset + q0 + 64 * wg) ||
            t0 + BK > Skv)
          grads_body(std::true_type(), t);
        else
          grads_body(std::false_type(), t);
      };

      // one key tile whose S and dP are in sacc and pacc: dQ += dS K,
      // each 64-column chunk's products taken into zeroed registers and
      // added in fp32 round-to-nearest; with `next`, the following tile's S
      // and dP run with dQ's last chunk (OVERLAP) or after it
      float tmp[32];
      auto tile = [&](auto next_tag, int t) {
        constexpr bool next = decltype(next_tag)::value;
        const uint32_t k_s = smem_u32(ks + stage(t) * C::KV_BYTES);
        grads(t);
        split_frag<BK>(pacc, dsa);
        if constexpr (next && C::OVERLAP)
          mbar_wait(bar_full(stage(t + 1)), phase(t + 1));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          issue_chunk<BK / 16, BK>(tmp, dsa, k_s, c);
          if constexpr (next && C::OVERLAP)
            if (c == NC - 1) issue_sdp(stage(t + 1));
          wgmma_commit();
          wgmma_wait<0>();
          add_tile(adq[c], tmp, false);
        }
        if constexpr (next && C::OVERLAP) {
          fence_regs(sacc);
          fence_regs(pacc);
        }
        release(bar_empty(stage(t)));
        if constexpr (next && !C::OVERLAP) {
          mbar_wait(bar_full(stage(t + 1)), phase(t + 1));
          sdp(stage(t + 1));
        }
      };

      if (my_tiles > 0) {
        mbar_wait(bar_full(stage(0)), phase(0));
        sdp(stage(0));
        int t = 0;
        for (; t + 1 < my_tiles; ++t) tile(std::true_type(), t);
        tile(std::false_type(), t);
      }
      // key tiles past this warpgroup's last query: nothing to add
      for (int t = my_tiles; t < n_tiles; ++t) {
        mbar_wait(bar_full(stage(t)), phase(t));
        release(bar_empty(stage(t)));
      }
      // every wgmma of this item has read its Q and dO
      release(bar_qfree(qb));
      it0 += n_tiles;

      store_rows<NC>(dq + static_cast<size_t>(bh) * Sq * HD +
                         static_cast<size_t>(q0) * HD,
                     adq, 64 * wg, Sq - q0, HD);
    }
  }
}

// ----------------------------------------------------------------- host
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int BH, Sq, Skv, HD;
  float scale;
  int causal, q_offset;
  cudaStream_t stream;
};

// q, k, v, dO maps with boxes of q_rows (q, dO) and kv_rows (k, v) rows
inline bool make_maps(CUtensorMap (&m)[4], const Args& a, int q_rows,
                      int kv_rows) {
  return make_map_bf16_3d(&m[0], a.q, a.BH, a.Sq, a.HD, q_rows) &&
         make_map_bf16_3d(&m[1], a.k, a.BH, a.Skv, a.HD, kv_rows) &&
         make_map_bf16_3d(&m[2], a.v, a.BH, a.Skv, a.HD, kv_rows) &&
         make_map_bf16_3d(&m[3], a.dout, a.BH, a.Sq, a.HD, q_rows);
}

// one persistent block per SM, or per work item when there are fewer
inline dim3 grid_for(int n_items) {
  const int n_sm = sm_count();
  return dim3(n_items < n_sm ? n_items : n_sm);
}

// #9: one launch of `kern` (a dK/dV kernel of config C)
template <class C, class Kern>
int launch_dkdv_with(Kern kern, const Args& a) {
  CUtensorMap m[4];
  if (!make_maps(m, a, C::BQ, C::BKB))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (e) return e;
  kern<<<grid_for(a.BH * ((a.Skv + C::BKB - 1) / C::BKB)), kThreads, C::SMEM,
         a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                     static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.BH,
                     a.Sq, a.Skv, a.HD, a.scale, a.causal, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dq(const Args& a) {
  using C = DqCfg<HDP>;
  CUtensorMap m[4];
  if (!make_maps(m, a, C::BQ, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_sm90<HDP>;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (e) return e;
  kern<<<grid_for(a.BH * ((a.Sq + C::BQ - 1) / C::BQ)), kThreads, C::SMEM,
         a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                     static_cast<bf16*>(a.dq), a.BH, a.Sq, a.Skv, a.HD,
                     a.scale, a.causal, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

// 0, or the error a call with a head dim outside [lo, hi] (or otherwise
// one the kernels cannot take) returns
inline int refuse(const Args& a, int lo, int hi) {
  if (a.HD < lo || a.HD > hi || a.HD % 16 || a.BH < 1 || a.Sq < 1 ||
      a.Skv < 1 || a.q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

inline Args make_args(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, int BH, int Sq, int Skv,
                      int HD, float scale, int causal, int q_offset,
                      void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, dk, dv, BH, Sq, Skv, HD,
              scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
}

}  // namespace
