// Flash attention forward over fp K/V at the bf16 carrier, on Hopper's
// tensor cores (sm_90a: TMA, mbarriers, wgmma, setmaxnreg).
//
// Replaces: src/repro/kernels/flash_attn.py --
//   flash_attention_fwd (#7, the forward without the LSE rows) and
//   _fwd_with_lse (#8, the forward of the flash_attention custom VJP):
//     flash_fwd_sm90<HDP, NQ, LSE = false / true>, one body.
// The float32 carrier keeps flash_attn.cu's CUDA-core forward: TF32 drops
// 13 bits of every operand and would leave the reference's tolerances.
// Layout (BH, S, d), each tensor contiguous and 16-byte aligned, q/k/v/o
// bfloat16, lse (BH, Sq) float32; d a multiple of 16 in [16, 256].
//
// What is computed, in the reference's rounding order (flash_attn.cu's
// forward, summed in another order): s = (q_f32 * scale) . k_f32, -1e30
// where kpos > q_offset + qpos or kpos >= Skv, the online-softmax
// recurrence over key tiles of kv_tile(d) rows (m from -1e30, l from 0,
// l summed over the unrounded fp32 p), p = expf(s - m) rounded to bf16
// before the P.V product, o = acc / max(l, 1e-30) (IEEE division), lse =
// m + logf(max(l, 1e-30)).  The key tile is part of the function: p is
// rounded against the running max of each tile, so BK is kv_tile(d)
// (repro_flash_kv_tile, held equal to kernels/flash_attn.py:kv_tile).
// Every product is exact in fp32: q, k, v and the rounded p are bf16, and
// x = fl(q * scale) is fed to the tensor cores either as one bf16 value
// (scale a power of two: d = 16, 64, 256) or as three bf16 terms hi + mid +
// lo == x (split_q), so the tensor cores change only how the fp32 sums are
// taken.  Their fp32 accumulation does not round to nearest, and the
// bf16 rounding of p magnifies an error of the scores, so S is taken one
// k16 step at a time (two at HDP 64 with one Q term) into zeroed registers
// and summed on the CUDA cores (see `scores` below).  NaN: fmaxf drops a
// NaN score from m, but p = expf(NaN - m) carries it into l and acc, and
// the floor on l is a comparison that keeps it.
//
// Bound at the training shape (BH = 96, S = 1024, d = 64, causal): 50.7 MB
// of q, k, v, o and lse, 0.01514 ms at 3.35 TB/s, over 12.9 GFLOP of
// bf16-exact products, 0.0130 ms at 989 TFLOP/s -- bytes by a little,
// both within 20%, so the kernel has to keep the tensor cores fed from
// tiles that arrive by themselves.  Design:
//  - persistent blocks, one per SM: work item w is a q block of 64 * NWG
//    rows (NWG consumer warpgroups of 64 rows each: three at HDP 64 with
//    one Q term, else two, one at HDP 256 with three), the heaviest
//    causal q blocks first; a producer warpgroup gives its registers to
//    the consumers (setmaxnreg 24 / 160 or 240);
//  - one producer thread streams each item's Q tile (two Q buffers where
//    they fit, so the next item's Q lands during this one) and the K/V
//    tiles into a ring of up to 8 stages by TMA (3-D maps over (BH, S, d),
//    128-byte swizzle, rows past S and columns past d zero-filled by the
//    hardware), under full and empty mbarriers;
//  - S = Q K^T by wgmma m64n{BK}k16 from shared memory (both K-major), in
//    zeroed register tiles of one or two k16 steps summed on the CUDA
//    cores; a tile's P V and the next tile's S share one wait;
//  - the softmax in registers on the accumulator fragment, compiled with
//    and without the mask (diagonal and ragged tiles only), every expf
//    outside any branch; p rounded to bf16 straight into the A fragment
//    of O += P V (wgmma m64n64k16 per 64 columns, V read MN-major);
//    nothing of S or P touches shared memory;
//  - a warpgroup skips the key tiles past its own last query (the PR-15
//    kernel's 64-row tiles, so the same tiles are summed); no atomics,
//    each o row written once.
// What holds it back (PERF.md): the softmax's instructions -- an accurate
// expf per score, the k-step sums, the max and the sum -- bound the tile
// loop, the tensor cores wait on them, and the epilogue's IEEE divisions
// each branch to a slow path.  Running the next tile's S, or this tile's
// P V, under the softmax cost registers or made ptxas serialize every
// wgmma (C7514), so the softmax waits for them.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the key tile of the bf16 forward, kernels/flash_attn.py:kv_tile
__host__ __device__ constexpr int kv_tile(int d) { return d <= 128 ? 64 : 32; }

template <int HDP, int NQ>
struct Cfg {
  static constexpr int BK = kv_tile(HDP);          // key rows per tile
  // consumer warpgroups: three Q terms at HDP 256 leave no room for 128
  // rows and a K/V ring; at HDP 64 with one Q term the registers fit
  // three, whose warps hide more of the softmax's latency
  static constexpr int NWG = (HDP == 256 && NQ == 3) ? 1
                             : (HDP == 64 && NQ == 1) ? 3 : 2;
  // registers of a consumer thread after setmaxnreg (the producer keeps
  // kProducerRegs): 65536 shared by the block's threads
  static constexpr int CREGS = NWG == 3 ? 160 : 240;
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int NC = HDP / 64;              // 64-column chunks
  static constexpr int Q_BYTES = NC * BQ * 128;    // one Q term
  static constexpr int KV_BYTES = NC * BK * 128;   // one K or V tile
  // Q buffers: two where they fit beside a 2-stage ring, so that a
  // persistent block loads its next item's Q during this one
  static constexpr int QBUF =
      2 * NQ * Q_BYTES + 4 * KV_BYTES + 2048 <= kSmemMax ? 2 : 1;
  static constexpr int NS_FIT =
      (kSmemMax - 2048 - QBUF * NQ * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;  // ring stages
  static constexpr int THREADS = 128 * (NWG + 1);
  // hi's score products in flight per batch: RING register tiles (BK / 2
  // registers each) of KSUB k16 steps; at HDP 64 with one Q term two
  // tiles of two k-steps, so that three warpgroups fit their registers
  static constexpr int KSUB = HDP == 64 && NQ == 1 ? 2 : 1;
  static constexpr int RING =
      KSUB == 2 || (HDP == 256 && NQ == 3) || (BK == 64 && NQ == 3) ? 2 : 4;
  // the tiles, the 1024-byte alignment slack and the barriers; at least
  // 120 KB so that one block holds an SM (setmaxnreg's budget is the SM's)
  static constexpr int SMEM_NEED =
      QBUF * NQ * Q_BYTES + 2 * NS * KV_BYTES + 1024 + 256;
  static constexpr int SMEM = SMEM_NEED > 122880 ? SMEM_NEED : 122880;
  static_assert(NS >= 2, "shared memory holds no 2-stage ring");
  static_assert(SMEM <= kSmemMax, "shared memory over the block limit");
};

// ---------------------------------------------------------------- kernel
template <int HDP, int NQ, bool LSE>
__global__ void __launch_bounds__(Cfg<HDP, NQ>::THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int BH, int Sq, int Skv, int HD,
               float scale, int causal, int q_offset) {
  using C = Cfg<HDP, NQ>;
  constexpr int BK = C::BK, BQ = C::BQ, NC = C::NC, NS = C::NS;
  constexpr int NWG = C::NWG;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;  // QBUF x NQ x [NC][BQ][64] bf16
  uint8_t* ks = qs + C::QBUF * NQ * C::Q_BYTES;  // NS x [NC][BK][64]
  uint8_t* vs = ks + NS * C::KV_BYTES;     // NS x [NC][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + NS * C::KV_BYTES);
  auto bar_q = [&](int b) { return smem_u32(bars + b); };
  auto bar_qfree = [&](int b) { return smem_u32(bars + 2 + b); };
  auto bar_full = [&](int s) { return smem_u32(bars + 4 + s); };
  auto bar_empty = [&](int s) { return smem_u32(bars + 4 + NS + s); };

  // persistent blocks: work item w is q block nqb - 1 - w / BH of head
  // w % BH, so the heaviest causal q blocks go first; a block takes items
  // blockIdx.x, + gridDim.x, ...  The block's last query position bounds
  // an item's causally live kv tiles.
  const int nqb = (Sq + BQ - 1) / BQ, n_items = BH * nqb;
  auto item_q0 = [&](int w) { return (nqb - 1 - w / BH) * BQ; };
  auto item_tiles = [&](int q0) {
    const int n = (Skv + BK - 1) / BK;
    return causal ? min(n, (q_offset + min(q0 + BQ, Sq) - 1) / BK + 1) : n;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < C::QBUF; ++b) {
      mbar_init(bar_q(b), 1);
      mbar_init(bar_qfree(b), 4 * NWG);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == NWG * 128) {
      int it = 0;  // kv tiles loaded by this block, over its items
      for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
        const int bh = w % BH, q0 = item_q0(w), n_tiles = item_tiles(q0);
        const int b = k % C::QBUF;
        // the consumers are done with the Q this buffer held before
        if (k >= C::QBUF) mbar_wait(bar_qfree(b), ((k / C::QBUF) - 1) & 1);
        mbar_expect_tx(bar_q(b), C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_3d(smem_u32(qs + b * NQ * C::Q_BYTES + c * BQ * 128), &tq,
                      bar_q(b), 64 * c, q0, bh);
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CREGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // and row0 + 8, in the block
    int it0 = 0;  // kv tiles consumed by this block before this item
    for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
      const int bh = w % BH, q0 = item_q0(w), n_tiles = item_tiles(q0);
      const int qb = k % C::QBUF;
      const int qpos[2] = {q_offset + q0 + row0, q_offset + q0 + row0 + 8};
      // this warpgroup's live tiles: none when its rows lie past Sq; under
      // the causal mask, those up to its own last query
      int my_tiles = n_tiles;
      if (q0 + 64 * wg >= Sq) {
        my_tiles = 0;
      } else if (causal) {
        const int wg_last = q_offset + min(q0 + 64 * (wg + 1), Sq) - 1;
        my_tiles = min(n_tiles, wg_last / BK + 1);
      }
      // a tile's ring stage and the parity of its full barrier
      auto stage = [&](int t) { return (it0 + t) % NS; };
      auto phase = [&](int t) { return ((it0 + t) / NS) & 1; };

      // q scaled (and split) in place, this warpgroup's 64 rows
      uint8_t* qk = qs + qb * NQ * C::Q_BYTES;
      mbar_wait(bar_q(qb), (k / C::QBUF) & 1);
      for (int i = tid; i < NC * 64 * 8; i += 128) {
        const int c = i / 512, r = i % 512;
        split_q<NQ>(qk, C::Q_BYTES, c * BQ * 128 + wg * 64 * 128 + r * 16,
                    scale);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
      float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
      const uint32_t q_base = smem_u32(qk) + wg * 64 * 128;

      // S = Q K^T of the tile in stage `st` over HDP / 16 k-steps (columns
      // past HD are zeros and add exact zeros).  The tensor cores' fp32 sums
      // do not round to nearest, so hi's products (which carry the score's
      // magnitude) land KSUB k-steps at a time in zeroed register tiles of
      // `ring`, RING tiles a batch, and the tiles are added in fp32 on the
      // CUDA cores in k-step order (sum_ring); mid's and lo's products (2^-8
      // and 2^-16 of hi's) chain in one accumulator, added last.
      float ring[C::RING][BK / 2], ml[BK / 2], sc[BK / 2];
      auto issue_s = [&](int st, int k0) {
        const uint32_t k_base = smem_u32(ks + st * C::KV_BYTES);
#pragma unroll
        for (int r = 0; r < C::RING; ++r) fence_regs(ring[r]);
        if constexpr (NQ == 3) fence_regs(ml);
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < C::RING; ++r)
#pragma unroll
          for (int j = 0; j < C::KSUB; ++j) {
            const int ks16 = k0 + r * C::KSUB + j;
            const uint32_t col = ks16 / 4, within = (ks16 % 4) * 32;
            const uint64_t b =
                gmma_desc(k_base + col * BK * 128 + within, 16, 1024);
            const uint32_t a = q_base + col * BQ * 128 + within;
            wgmma_ss<BK>(ring[r], gmma_desc(a, 16, 1024), b, j > 0);
#pragma unroll
            for (int term = 1; term < NQ; ++term)
              wgmma_ss<BK>(ml, gmma_desc(a + term * C::Q_BYTES, 16, 1024),
                               b, ks16 + term > 1);
          }
      };
      auto sum_ring = [&](int k0) {
#pragma unroll
        for (int r = 0; r < C::RING; ++r) add_tile(sc, ring[r], k0 + r == 0);
        if constexpr (NQ == 3)
          if (k0 + C::RING * C::KSUB == HDP / 16) add_tile(sc, ml, false);
      };
      // the batches of S from k-step k0 on, into sc
      auto scores_from = [&](int st, int k0) {
#pragma unroll
        for (; k0 < HDP / 16; k0 += C::RING * C::KSUB) {
          issue_s(st, k0);
          wgmma_commit();
          wgmma_wait<0>();
          sum_ring(k0);
        }
      };

      // mask (only where a key of the tile lies past Skv or past this
      // warpgroup's first query), running max, p = exp(s - m) (fp32 for l,
      // bf16 into P's A fragment), acc *= alpha
      uint32_t pa[BK / 16][4];
      // (compiled twice, with and without the mask, so that the tiles that
      // need none run no per-key test)
      auto softmax_body = [&](auto masked_tag, int t) {
        constexpr bool masked = decltype(masked_tag)::value;
        const int t0 = t * BK;
        float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = t0 + 8 * j + 2 * c4 + e;
              float& v = sc[4 * j + 2 * i + e];
              if (masked && (key >= Skv || (causal && key > qpos[i])))
                v = -1e30f;
              mx[i] = fmaxf(mx[i], v);
            }
        float m_new[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          m_new[i] = fmaxf(m[i], mx[i]);
        }
        // expf on every key, outside any branch (a branch per key keeps the
        // exponentials from overlapping); then p = 0 past Skv
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = sc[4 * j + 2 * i + e];
              v = expf(v - m_new[i]);
            }
        if constexpr (masked) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (t0 + 8 * j + 2 * c4 + e >= Skv)
                sc[4 * j + e] = sc[4 * j + 2 + e] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) psum[i] += sc[4 * j + 2 * i + e];
        // k16 slice kk of P's A fragment holds S columns 16kk..16kk+15
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
          const float alpha = expf(m[i] - m_new[i]);
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
      };
      auto softmax = [&](int t) {
        const int t0 = t * BK;
        if (t0 + BK > Skv || (causal && t0 + BK - 1 > q_offset + q0 + 64 * wg))
          softmax_body(std::true_type(), t);
        else
          softmax_body(std::false_type(), t);
      };
      // O += P V for the tile in stage st, per 64 output columns
      auto issue_pv = [&](int st) {
        const uint32_t v_base = smem_u32(vs + st * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs_n64(acc[c], pa[kk],
                         gmma_desc(v_base + c * BK * 128 + kk * 2048, BK * 128,
                                   1024),
                         1);
      };
      auto pv_done = [&] {
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      };
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(st));
      };

      // this tile's P V and the first batch of the next tile's S go to the
      // tensor cores together, so each tile waits for its wgmmas once
      constexpr int B = C::RING * C::KSUB;
      int t = 0;
      if (my_tiles > 0) {
        mbar_wait(bar_full(stage(0)), phase(0));
        scores_from(stage(0), 0);
        for (; t + 1 < my_tiles; ++t) {
          softmax(t);
          mbar_wait(bar_full(stage(t + 1)), phase(t + 1));
          issue_pv(stage(t));
          issue_s(stage(t + 1), 0);
          wgmma_commit();
          wgmma_wait<0>();
          pv_done();
          release(stage(t));
          sum_ring(0);
          scores_from(stage(t + 1), B);
        }
        softmax(t);
        issue_pv(stage(t));
        wgmma_commit();
        wgmma_wait<0>();
        pv_done();
        release(stage(t));
        ++t;
      }
      // key tiles past this warpgroup's last query: nothing to add
      for (; t < n_tiles; ++t) {
        mbar_wait(bar_full(stage(t)), phase(t));
        release(stage(t));
      }
      // every wgmma of this item has read its Q: the buffer may be refilled
      if (lane == 0) mbar_arrive(bar_qfree(qb));
      it0 += n_tiles;

      // o = acc / max(l, 1e-30), each row written once
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 8 * i;
        if (my_tiles == 0 || qi >= Sq) continue;
        const float lf = floor_l(l[i]);
        bf16* orow = o + (static_cast<size_t>(bh) * Sq + qi) * HD;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + 8 * j + 2 * c4;
            if (col < HD)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __halves2bfloat162(
                      __float2bfloat16_rn(acc[c][4 * j + 2 * i] / lf),
                      __float2bfloat16_rn(acc[c][4 * j + 2 * i + 1] / lf));
          }
        if (LSE && c4 == 0)
          lse[static_cast<size_t>(bh) * Sq + qi] = m[i] + logf(lf);
      }
    }
  }
}

// ----------------------------------------------------------------- host
template <int HDP, int NQ>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Skv, int HD, float scale, int causal,
           int q_offset, cudaStream_t stream) {
  using C = Cfg<HDP, NQ>;
  CUtensorMap tq, tk, tv;
  if (!make_map_bf16_3d(&tq, q, BH, Sq, HD, C::BQ) ||
      !make_map_bf16_3d(&tk, k, BH, Skv, HD, C::BK) ||
      !make_map_bf16_3d(&tv, v, BH, Skv, HD, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sm = sm_count();
  // one persistent block per SM, or per work item when there are fewer
  const int n_items = BH * ((Sq + C::BQ - 1) / C::BQ);
  const dim3 grid(n_items < n_sm ? n_items : n_sm);
  auto kern = lse != nullptr ? flash_fwd_sm90<HDP, NQ, true>
                             : flash_fwd_sm90<HDP, NQ, false>;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (e) return e;
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), BH, Sq,
      Skv, HD, scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BH, Sq, HD), k/v (BH, Skv, HD) bf16 -> o (BH, Sq, HD) bf16; lse (BH,
// Sq) float32, or null for the forward without it (#7).  HD a multiple of
// 16 in [16, 256]; every pointer 16-byte aligned.
extern "C" int repro_flash_fwd_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int BH,
                                    int Sq, int Skv, int HD, float scale,
                                    int causal, int q_offset, void* stream) {
  if (HD < 16 || HD > 256 || HD % 16 || BH < 1 || Sq < 1 || Skv < 1 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  // a power-of-two scale (d = 16, 64, 256) makes q * scale exact in bf16:
  // one Q term; any other takes three (exact for every scale)
  int ex;
  const bool pow2 = frexpf(scale, &ex) == 0.5f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HDP, NQ)                                              \
  launch<HDP, NQ>(q, k, v, o, lse, BH, Sq, Skv, HD, scale, causal, q_offset, \
                  st)
  switch ((HD + 63) / 64) {
    case 1: return pow2 ? REPRO_LAUNCH(64, 1) : REPRO_LAUNCH(64, 3);
    case 2: return REPRO_LAUNCH(128, 3);
    case 3: return REPRO_LAUNCH(192, 3);
    default: return pow2 ? REPRO_LAUNCH(256, 1) : REPRO_LAUNCH(256, 3);
  }
#undef REPRO_LAUNCH
}

// key rows per tile of the bf16 forward at head dim hd (its rounding of p
// depends on it); tests hold kernels/flash_attn.py:kv_tile equal to it
extern "C" int repro_flash_kv_tile(int hd) {
  switch ((hd + 63) / 64) {
    case 1: return Cfg<64, 1>::BK;
    case 2: return Cfg<128, 3>::BK;
    case 3: return Cfg<192, 3>::BK;
    default: return Cfg<256, 1>::BK;
  }
}
