// Flash attention backward over fp K/V at the bf16 carrier, on Hopper's
// tensor cores (sm_90a: TMA, mbarriers, wgmma, setmaxnreg).
//
// Replaces: src/repro/kernels/flash_attn.py:_fa_bwd --
//   its dK/dV pallas_call (#9, _flash_bwd_dkdv_kernel): flash_bwd_dkdv_sm90;
//   its dQ pallas_call (#10, _flash_bwd_dq_kernel): flash_bwd_dq_sm90.
// The float32 carrier, and head dims above kMaxHeadDim, keep flash_attn.cu's
// CUDA-core kernels: TF32 drops 13 bits of every operand, and at d > 128
// the dK and dV accumulators alone take 128 registers a thread or more.
// Layout (BH, S, d), each tensor contiguous and 16-byte aligned, q/k/v/dO
// and the gradients bfloat16, lse and delta (BH, Sq) float32; d a multiple
// of 16 in [16, 128].
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
// Bound at the training shape (BH = 96, S = 1024, d = 64, causal: 50.4 M
// visible pairs): #9 does eight products of 2 * d FLOPs a pair (q.k, dO.v,
// three for p^T dO, three for ds^T q), 51.6 GFLOP, 0.0522 ms at 989
// TFLOP/s, against 76 MB of bytes (0.0228 ms); #10 five (q.k, dO.v, three
// for ds k), 32.3 GFLOP, 0.0326 ms, against 0.0190 ms of bytes: operations
// bound both, so the products run on the tensor cores, fed by TMA.  Design:
//  - persistent blocks, one per SM, two consumer warpgroups and one
//    producer warpgroup that gives its registers away (setmaxnreg 24 / 240);
//  - #9: work item = 128 key rows of one head (64 per consumer warpgroup),
//    the key blocks near position 0 (which see the most query tiles) first.
//    The producer loads the item's K and V once (two buffers, so the next
//    item's land during this one) and streams (Q, dO) query tiles of BQ
//    rows (64; 32 at d > 64, for the registers) into a ring by TMA, while
//    a second producer warp copies each tile's lse and delta rows beside
//    them; full and empty mbarriers.  Per tile a consumer computes S^T = K
//    Q^T and dP^T = V dO^T (wgmma from shared memory, both K-major), p^T
//    and ds^T on the fragment (lse and delta per column, from shared
//    memory; the mask compiled only into diagonal and ragged tiles), then
//    dV += sum_terms P^T dO and dK += sum_terms dS^T Q (A from registers, B
//    = dO and Q read MN-major); ds is split while dV's wgmmas run.  dK and
//    dV stay in registers and each row is written once.  A warpgroup
//    starts at the first query tile that sees its keys.  The next tile's
//    S^T and dP^T go to the tensor cores with this tile's dK.
//  - #10: work item = 128 query rows of one head (64 per consumer
//    warpgroup), the causally heaviest first.  Q and dO of the item (two
//    buffers) and K/V tiles of 64 keys in a ring, by TMA; lse and delta per
//    row in registers.  Per tile S = Q K^T and dP = dO V^T, ds on the
//    fragment, dQ += sum_terms dS K (B = K read MN-major); the next tile's
//    S and dP go to the tensor cores with this tile's dQ.  A warpgroup
//    stops at the last key tile its last query sees.
//  - the tensor cores' fp32 sums do not round to nearest (flash_fwd_sm90.cu),
//    and over a long chain their error grows with the running sum: each
//    tile's dV, dK or dQ products (per 64-column chunk, for the registers)
//    land in zeroed registers and are added to the running sums with
//    __fadd_rn (add_tile): chained over every tile, dk and dv came within
//    1.2x of phase 13's rel L2 limit; per tile they stay 3.2x under it,
//    level with an fp32-ordered plain sum (PERF.md, H100 80GB HBM3, 700 W).
//  - 128-byte swizzled tiles (3-D maps over (BH, S, d), rows past S and
//    columns past d zero-filled by the hardware); nothing of S, P or dS
//    touches shared or global memory; no atomics, each output row has one
//    writer, so a second launch repeats the bits.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the largest head dim the tensor-core backward takes
// (kernels/flash_attn.py:FLASH_BWD_SM90_MAX_HEAD_DIM)
constexpr int kMaxHeadDim = 128;
constexpr int kConsumerRegs = 240;
constexpr int kNWG = 2;  // consumer warpgroups, 64 rows each
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

// ------------------------------------------------------------ #9: dK, dV
template <int HDP>
struct DkdvCfg {
  static constexpr int BKB = 64 * kNWG;          // key rows per work item
  static constexpr int BQ = HDP == 64 ? 64 : 32;  // query rows per tile
  static constexpr int NC = HDP / 64;             // 64-column chunks
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

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int BH, int Sq, int Skv, int HD,
                    float scale, int causal, int q_offset) {
  using C = DkdvCfg<HDP>;
  constexpr int BQ = C::BQ, BKB = C::BKB, NC = C::NC, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kvs = smem;  // KVBUF x (K, V) x [NC][BKB][64] bf16
  uint8_t* ts = kvs + C::KVBUF * 2 * C::KV_BYTES;  // NS x (Q, dO) [NC][BQ][64]
  float* rows = reinterpret_cast<float*>(ts + NS * 2 * C::T_BYTES);  // NS x 2BQ
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + NS * 2 * BQ);
  auto bar_kv = [&](int b) { return smem_u32(bars + b); };
  auto bar_kvfree = [&](int b) { return smem_u32(bars + 2 + b); };
  auto bar_full = [&](int s) { return smem_u32(bars + 4 + s); };
  auto bar_empty = [&](int s) { return smem_u32(bars + 4 + NS + s); };

  // work item w: key block w / BH of head w % BH, so the key blocks that
  // see the most query tiles go first; a block takes items blockIdx.x, +
  // gridDim.x, ...  A key row kr first meets query tile first_tile(kr).
  const int nkb = (Skv + BKB - 1) / BKB, n_items = BH * nkb;
  const int n_qt = (Sq + BQ - 1) / BQ;
  auto first_tile = [&](int kr) {
    return causal ? max(0, kr - q_offset) / BQ : 0;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < C::KVBUF; ++b) {
      mbar_init(bar_kv(b), 1);
      mbar_init(bar_kvfree(b), 4 * kNWG);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full(s), 1 + 32);  // the TMA thread and the rows warp
      mbar_init(bar_empty(s), 4 * kNWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kNWG) {
    // ------------------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pwarp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (pwarp == 0 && lane == 0) {
      // K and V once per item, the (Q, dO) tiles through the ring
      int it = 0;
      for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
        const int bh = w % BH, k0 = (w / BH) * BKB, b = k % C::KVBUF;
        if (k >= C::KVBUF) mbar_wait(bar_kvfree(b), ((k / C::KVBUF) - 1) & 1);
        mbar_expect_tx(bar_kv(b), 2 * C::KV_BYTES);
        uint8_t* kb = kvs + b * 2 * C::KV_BYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(smem_u32(kb + c * BKB * 128), &tk, bar_kv(b), 64 * c,
                      k0, bh);
          tma_load_3d(smem_u32(kb + C::KV_BYTES + c * BKB * 128), &tv,
                      bar_kv(b), 64 * c, k0, bh);
        }
        for (int t = first_tile(k0); t < n_qt; ++t, ++it) {
          const int s = it % NS;
          if (it >= NS) mbar_wait(bar_empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(bar_full(s), 2 * C::T_BYTES);
          uint8_t* tb = ts + s * 2 * C::T_BYTES;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_3d(smem_u32(tb + c * BQ * 128), &tq, bar_full(s),
                        64 * c, t * BQ, bh);
            tma_load_3d(smem_u32(tb + C::T_BYTES + c * BQ * 128), &tdo,
                        bar_full(s), 64 * c, t * BQ, bh);
          }
        }
      }
    } else if (pwarp == 1) {
      // each tile's lse and delta rows beside it (0 past Sq)
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int bh = w % BH, k0 = (w / BH) * BKB;
        for (int t = first_tile(k0); t < n_qt; ++t, ++it) {
          const int s = it % NS;
          if (it >= NS) mbar_wait(bar_empty(s), ((it / NS) & 1) ^ 1);
          float* r = rows + s * 2 * BQ;
          for (int i = lane; i < BQ; i += 32) {
            const int qi = t * BQ + i;
            const size_t at = static_cast<size_t>(bh) * Sq + qi;
            r[i] = qi < Sq ? lse[at] : 0.0f;
            r[BQ + i] = qi < Sq ? delta[at] : 0.0f;
          }
          mbar_arrive(bar_full(s));
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int krow = 16 * warp + g;  // and krow + 8, in the warpgroup's 64
    int it0 = 0;  // query tiles consumed by this block before this item
    for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
      const int bh = w % BH, k0 = (w / BH) * BKB, b = k % C::KVBUF;
      const int t_first = first_tile(k0);
      const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
      // its first live tile; none when its keys lie past Skv or see no query
      const int my_first =
          kw0 < Skv ? min(n_qt, max(t_first, first_tile(kw0))) : n_qt;
      auto stage = [&](int t) { return (it0 + t - t_first) % NS; };
      auto phase = [&](int t) { return ((it0 + t - t_first) / NS) & 1; };

      float adk[NC][32], adv[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) adk[c][i] = adv[c][i] = 0.0f;
      mbar_wait(bar_kv(b), (k / C::KVBUF) & 1);
      const uint32_t k_base =
          smem_u32(kvs + b * 2 * C::KV_BYTES) + wg * 64 * 128;
      const uint32_t v_base = k_base + C::KV_BYTES;

      float sacc[BQ / 2], pacc[BQ / 2];
      uint32_t pa[3][BQ / 16][4], dsa[3][BQ / 16][4];
      // S^T = K Q^T and dP^T = V dO^T of the tile in stage st
      auto issue_st = [&](int st) {
        const uint32_t q_s = smem_u32(ts + st * 2 * C::T_BYTES);
        const uint32_t do_s = q_s + C::T_BYTES;
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
          const uint32_t col = ks / 4, within = (ks % 4) * 32;
          const uint32_t ka = col * BKB * 128 + within;
          const uint32_t kb = col * BQ * 128 + within;
          wgmma_ss<BQ>(sacc, gmma_desc(k_base + ka, 16, 1024),
                       gmma_desc(q_s + kb, 16, 1024), ks > 0);
          wgmma_ss<BQ>(pacc, gmma_desc(v_base + ka, 16, 1024),
                       gmma_desc(do_s + kb, 16, 1024), ks > 0);
        }
      };
      // p^T into sacc and ds^T into pacc; lse and delta by column (query)
      auto grads_body = [&](auto masked_tag, int st, int t) {
        constexpr bool masked = decltype(masked_tag)::value;
        const float* rl = rows + st * 2 * BQ;
        const int t0 = t * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(rl + 8 * j + 2 * c4);
          const float2 d2 =
              *reinterpret_cast<const float2*>(rl + BQ + 8 * j + 2 * c4);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              const int qi = t0 + 8 * j + 2 * c4 + e;
              // __fmul_rn: s is rounded before the subtraction, never fused
              float s = __fmul_rn(scale, sacc[x]);
              if (masked && causal && kw0 + krow + 8 * i > q_offset + qi)
                s = -1e30f;
              float p = expf(s - (e ? l2.y : l2.x));
              if (masked && qi >= Sq) p = 0.0f;
              sacc[x] = p;
              pacc[x] = p * (pacc[x] - (e ? d2.y : d2.x)) * scale;
            }
        }
      };
      auto grads = [&](int st, int t) {
        const int t0 = t * BQ;
        if ((causal && kw0 + 63 > q_offset + t0) || t0 + BQ > Sq)
          grads_body(std::true_type(), st, t);
        else
          grads_body(std::false_type(), st, t);
      };

      // one query tile whose S^T and dP^T are in sacc and pacc: dV += P^T
      // dO and dK += dS^T Q, each 64-column chunk's products taken into
      // zeroed registers and added to the running sums in fp32
      // round-to-nearest (the tensor cores' own fp32 sums do not round to
      // nearest, and a tile's products stay small against the sums); with
      // `next`, the following tile's S^T and dP^T go to the tensor cores
      // with dK's last chunk
      float tmp[32];
      auto tile = [&](auto next_tag, int t) {
        constexpr bool next = decltype(next_tag)::value;
        const int st = stage(t);
        const uint32_t q_s = smem_u32(ts + st * 2 * C::T_BYTES);
        grads(st, t);
        split_frag<BQ>(sacc, pa);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          issue_chunk<BQ / 16, BQ>(tmp, pa, q_s + C::T_BYTES, c);  // dV
          wgmma_commit();
          if (c == 0) split_frag<BQ>(pacc, dsa);  // while dV's products run
          wgmma_wait<0>();
          add_tile(adv[c], tmp, false);
        }
        if constexpr (next) mbar_wait(bar_full(stage(t + 1)), phase(t + 1));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          issue_chunk<BQ / 16, BQ>(tmp, dsa, q_s, c);               // dK
          if constexpr (next)
            if (c == NC - 1) issue_st(stage(t + 1));
          wgmma_commit();
          wgmma_wait<0>();
          add_tile(adk[c], tmp, false);
        }
        if constexpr (next) {
          fence_regs(sacc);
          fence_regs(pacc);
        }
        release(bar_empty(st));
      };

      int t = t_first;
      for (; t < my_first; ++t) {  // tiles that see none of its keys
        mbar_wait(bar_full(stage(t)), phase(t));
        release(bar_empty(stage(t)));
      }
      if (t < n_qt) {
        mbar_wait(bar_full(stage(t)), phase(t));
        issue_st(stage(t));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        for (; t + 1 < n_qt; ++t) tile(std::true_type(), t);
        tile(std::false_type(), t);
      }
      // every wgmma of this item has read its K and V
      release(bar_kvfree(b));
      it0 += max(0, n_qt - t_first);

      const size_t base = static_cast<size_t>(bh) * Skv * HD;
      store_rows<NC>(dk + base, adk, kw0, Skv, HD);
      store_rows<NC>(dv + base, adv, kw0, Skv, HD);
    }
  }
}

// ----------------------------------------------------------------- #10: dQ
template <int HDP>
struct DqCfg {
  static constexpr int BQ = 64 * kNWG;             // query rows per item
  static constexpr int BK = 64;                    // key rows per tile
  static constexpr int NC = HDP / 64;
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
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t col = kk / 4, within = (kk % 4) * 32;
          const uint32_t qa = col * BQ * 128 + within;
          const uint32_t kb = col * BK * 128 + within;
          wgmma_ss_n64(sacc, gmma_desc(q_base + qa, 16, 1024),
                       gmma_desc(k_s + kb, 16, 1024), kk > 0);
          wgmma_ss_n64(pacc, gmma_desc(do_base + qa, 16, 1024),
                       gmma_desc(v_s + kb, 16, 1024), kk > 0);
        }
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
      // added in fp32 round-to-nearest (as #9's); with `next`, the
      // following tile's S and dP run with dQ's last chunk
      float tmp[32];
      auto tile = [&](auto next_tag, int t) {
        constexpr bool next = decltype(next_tag)::value;
        const uint32_t k_s = smem_u32(ks + stage(t) * C::KV_BYTES);
        grads(t);
        split_frag<BK>(pacc, dsa);
        if constexpr (next) mbar_wait(bar_full(stage(t + 1)), phase(t + 1));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          issue_chunk<BK / 16, BK>(tmp, dsa, k_s, c);
          if constexpr (next)
            if (c == NC - 1) issue_sdp(stage(t + 1));
          wgmma_commit();
          wgmma_wait<0>();
          add_tile(adq[c], tmp, false);
        }
        if constexpr (next) {
          fence_regs(sacc);
          fence_regs(pacc);
        }
        release(bar_empty(stage(t)));
      };

      if (my_tiles > 0) {
        mbar_wait(bar_full(stage(0)), phase(0));
        issue_sdp(stage(0));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
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
bool make_maps(CUtensorMap (&m)[4], const Args& a, int q_rows, int kv_rows) {
  return make_map_bf16_3d(&m[0], a.q, a.BH, a.Sq, a.HD, q_rows) &&
         make_map_bf16_3d(&m[1], a.k, a.BH, a.Skv, a.HD, kv_rows) &&
         make_map_bf16_3d(&m[2], a.v, a.BH, a.Skv, a.HD, kv_rows) &&
         make_map_bf16_3d(&m[3], a.dout, a.BH, a.Sq, a.HD, q_rows);
}

// one persistent block per SM, or per work item when there are fewer
dim3 grid_for(int n_items) {
  const int n_sm = sm_count();
  return dim3(n_items < n_sm ? n_items : n_sm);
}

template <int HDP>
int launch_dkdv(const Args& a) {
  using C = DkdvCfg<HDP>;
  CUtensorMap m[4];
  if (!make_maps(m, a, C::BQ, C::BKB))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkdv_sm90<HDP>;
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

// 0, or the error a call the kernels cannot take returns
int refuse(const Args& a) {
  if (a.HD < 16 || a.HD > kMaxHeadDim || a.HD % 16 || a.BH < 1 || a.Sq < 1 ||
      a.Skv < 1 || a.q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

// dK, dV (BH, Skv, HD) bf16 from q, dO (BH, Sq, HD), k, v (BH, Skv, HD)
// bf16 and lse, delta (BH, Sq) float32; HD a multiple of 16 in [16, 128],
// q, k, v, dO 16-byte aligned (cudaErrorMisalignedAddress otherwise)
extern "C" int repro_flash_bwd_sm90_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq,
    int Skv, int HD, float scale, int causal, int q_offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, BH, Sq,
               Skv, HD, scale, causal, q_offset,
               static_cast<cudaStream_t>(stream)};
  if (int e = refuse(a)) return e;
  return HD <= 64 ? launch_dkdv<64>(a) : launch_dkdv<128>(a);
}

// dQ (BH, Sq, HD) bf16 from the same inputs
extern "C" int repro_flash_bwd_sm90_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int BH, int Sq, int Skv,
                                       int HD, float scale, int causal,
                                       int q_offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, BH,
               Sq, Skv, HD, scale, causal, q_offset,
               static_cast<cudaStream_t>(stream)};
  if (int e = refuse(a)) return e;
  return HD <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

// the largest head dim the tensor-core backward takes; tests hold
// kernels/flash_attn.py:FLASH_BWD_SM90_MAX_HEAD_DIM equal to it
extern "C" int repro_flash_bwd_max_head_dim() { return kMaxHeadDim; }
