// Flash attention backward over fp K/V at the bf16 carrier on Hopper's
// tensor cores, head dims 16-128 (flash_bwd_sm90.cuh holds the parts both
// libraries share, its note what is computed and the common design).
//
// Replaces: src/repro/kernels/flash_attn.py:_fa_bwd --
//   its dK/dV pallas_call (#9, _flash_bwd_dkdv_kernel): flash_bwd_dkdv_sm90;
//   its dQ pallas_call (#10, _flash_bwd_dq_kernel): flash_bwd_dq_sm90.
// Head dims 144-256 are flash_bwd_sm90_wide.cu's, a library of its own
// (so the two build in parallel).
//
// Bound at the training shape (BH = 96, S = 1024, d = 64, causal: 50.4 M
// visible pairs): #9 does eight products of 2 * d FLOPs a pair (q.k, dO.v,
// three for p^T dO, three for ds^T q), 51.6 GFLOP, 0.0522 ms at 989
// TFLOP/s, against 76 MB of bytes (0.0228 ms); #10 five (q.k, dO.v, three
// for ds k), 32.3 GFLOP, 0.0326 ms, against 0.0190 ms of bytes: operations
// bound both, so the products run on the tensor cores, fed by TMA.
// #9's design: work item = 128 key rows of one head (64 per consumer
// warpgroup), the key blocks near position 0 (which see the most query
// tiles) first.  The producer loads the item's K and V once (two buffers,
// so the next item's land during this one) and streams (Q, dO) query tiles
// of BQ rows (64; 32 at d > 64, for the registers) into a ring by TMA,
// while a second producer warp copies each tile's lse and delta rows
// beside them; full and empty mbarriers.  Per tile a consumer computes S^T
// = K Q^T and dP^T = V dO^T (wgmma from shared memory, both K-major), p^T
// and ds^T on the fragment (lse and delta per column, from shared memory;
// the mask compiled only into diagonal and ragged tiles), then dV +=
// sum_terms P^T dO and dK += sum_terms dS^T Q (A from registers, B = dO
// and Q read MN-major); ds is split while dV's wgmmas run.  dK and dV stay
// in registers (d registers a thread: the reason this design stops at 128)
// and each row is written once.  A warpgroup starts at the first query
// tile that sees its keys.  The next tile's S^T and dP^T go to the tensor
// cores with this tile's dK.
#include "flash_bwd_sm90.cuh"

namespace {

// the largest head dim of this library
// (kernels/flash_attn.py:FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM)
constexpr int kMaxHeadDim = 128;

// ------------------------------------------------------------ #9: dK, dV
template <int HDP>
struct DkdvCfg : DkdvPlan<HDP / 64, 64 * kNWG, HDP == 64 ? 64 : 32> {};

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
  const DkdvSmem<C> sm(smem_raw +
                       ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nkb = (Skv + BKB - 1) / BKB, n_items = BH * nkb;
  const int n_qt = (Sq + BQ - 1) / BQ;
  auto first_tile = [&](int kr) { return sm.first_tile(kr, causal, q_offset); };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (wg == kNWG) {
    dkdv_produce(sm, &tq, &tk, &tv, &tdo, lse, delta, BH, Sq, Skv, causal,
                 q_offset);
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
      mbar_wait(sm.kv(b), (k / C::KVBUF) & 1);
      const uint32_t k_base =
          smem_u32(sm.kvs + b * 2 * C::KV_BYTES) + wg * 64 * 128;
      const uint32_t v_base = k_base + C::KV_BYTES;

      float sacc[BQ / 2], pacc[BQ / 2];
      uint32_t pa[3][BQ / 16][4], dsa[3][BQ / 16][4];
      // S^T = K Q^T and dP^T = V dO^T of the tile in stage st
      auto issue_st = [&](int st) {
        const uint32_t q_s = smem_u32(sm.ts + st * 2 * C::T_BYTES);
        const uint32_t do_s = q_s + C::T_BYTES;
        const uint32_t ka0 = opaque(k_base), va0 = opaque(v_base);
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
          const uint32_t col = ks / 4, within = (ks % 4) * 32;
          const uint32_t ka = col * BKB * 128 + within;
          const uint32_t kb = col * BQ * 128 + within;
          wgmma_ss<BQ>(sacc, gmma_desc(ka0 + ka, 16, 1024),
                       gmma_desc(q_s + kb, 16, 1024), ks > 0);
          wgmma_ss<BQ>(pacc, gmma_desc(va0 + ka, 16, 1024),
                       gmma_desc(do_s + kb, 16, 1024), ks > 0);
        }
      };
      // p^T into sacc and ds^T into pacc; lse and delta by column (query)
      auto grads_body = [&](auto masked_tag, int st, int t) {
        constexpr bool masked = decltype(masked_tag)::value;
        const float* rl = sm.rows + st * 2 * BQ;
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
        const uint32_t q_s = smem_u32(sm.ts + st * 2 * C::T_BYTES);
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
        if constexpr (next) mbar_wait(sm.full(stage(t + 1)), phase(t + 1));
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
        release(sm.empty(st));
      };

      int t = t_first;
      for (; t < my_first; ++t) {  // tiles that see none of its keys
        mbar_wait(sm.full(stage(t)), phase(t));
        release(sm.empty(stage(t)));
      }
      if (t < n_qt) {
        mbar_wait(sm.full(stage(t)), phase(t));
        issue_st(stage(t));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        for (; t + 1 < n_qt; ++t) tile(std::true_type(), t);
        tile(std::false_type(), t);
      }
      // every wgmma of this item has read its K and V
      release(sm.kvfree(b));
      it0 += max(0, n_qt - t_first);

      const size_t base = static_cast<size_t>(bh) * Skv * HD;
      store_rows<NC>(dk + base, adk, kw0, Skv, HD);
      store_rows<NC>(dv + base, adv, kw0, Skv, HD);
    }
  }
}

}  // namespace

// dK, dV (BH, Skv, HD) bf16 from q, dO (BH, Sq, HD), k, v (BH, Skv, HD)
// bf16 and lse, delta (BH, Sq) float32; HD a multiple of 16 in [16, 128],
// q, k, v, dO 16-byte aligned (cudaErrorMisalignedAddress otherwise)
extern "C" int repro_flash_bwd_sm90_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq,
    int Skv, int HD, float scale, int causal, int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, BH, Sq,
                           Skv, HD, scale, causal, q_offset, stream);
  if (int e = refuse(a, 16, kMaxHeadDim)) return e;
  return HD <= 64
             ? launch_dkdv_with<DkdvCfg<64>>(flash_bwd_dkdv_sm90<64>, a)
             : launch_dkdv_with<DkdvCfg<128>>(flash_bwd_dkdv_sm90<128>, a);
}

// dQ (BH, Sq, HD) bf16 from the same inputs
extern "C" int repro_flash_bwd_sm90_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int BH, int Sq, int Skv,
                                       int HD, float scale, int causal,
                                       int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           BH, Sq, Skv, HD, scale, causal, q_offset, stream);
  if (int e = refuse(a, 16, kMaxHeadDim)) return e;
  return HD <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

// the largest head dim of this library; tests hold
// kernels/flash_attn.py:FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM equal to it
extern "C" int repro_flash_bwd_max_head_dim() { return kMaxHeadDim; }
