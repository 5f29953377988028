// Flash attention backward over fp K/V at the bf16 carrier on Hopper's
// tensor cores, head dims 144-256 (flash_bwd_sm90.cuh holds the parts both
// libraries share, its note what is computed and the common design; head
// dims 16-128 are flash_bwd_sm90.cu's).
//
// Replaces: src/repro/kernels/flash_attn.py:_fa_bwd --
//   its dK/dV pallas_call (#9, _flash_bwd_dkdv_kernel):
//     flash_bwd_dkdv_split_sm90 <192> (d 144-192) and <256> (d 208-256);
//   its dQ pallas_call (#10, _flash_bwd_dq_kernel): flash_bwd_dq_sm90 <192>,
//     <256> (the shared body, BK = 32).
// Head dim 160 (Zamba2-2.7B's shared block) runs on 192 columns, 256
// (Gemma-2B) on 256: the contraction over d is 10 or 16 k16 slices, the
// accumulators three or four 64-column chunks.
//
// Bound (phase 13's count): #9 does eight products of 2 * d FLOPs a
// visible pair (q.k, dO.v, three for p^T dO, three for ds^T q), #10 five;
// at B 2, S 4096, 32 heads of 160, causal: 1,374.7 and 859.2 GFLOP, 1.390
// and 0.869 ms at 989 TFLOP/s, operations bound (bytes: about 0.03 ms).
//
// What holds #9 back above d = 128 is registers: flash_bwd_sm90.cu's work
// item gives each consumer warpgroup 64 keys with both dK and dV, HDP fp32
// registers a thread (192 or 256 here) beside S^T, dP^T, the three-term A
// fragments and a chunk's products, against setmaxnreg's 240.  So the two
// consumer warpgroups split one item of 64 keys by output: warpgroup 0
// keeps dV (NC * 32 registers), warpgroup 1 dK.  Per query tile of BQ = 32
// rows both compute S^T = K Q^T, p^T on the fragment; warpgroup 1 also
// dP^T = V dO^T and ds^T; then dV += sum_terms P^T dO (warpgroup 0) and dK
// += sum_terms dS^T Q (warpgroup 1), each 64-column chunk into zeroed
// registers and added with __fadd_rn.  So the kernel runs nine products a
// pair where the function needs eight (S^T twice; the bound keeps eight),
// and warpgroup 0 does four of them to warpgroup 1's five: the tensor
// cores are the SM's, so the lighter warpgroup's gaps are the heavier one's
// issue slots.  Sharing S^T through shared memory instead would cost a
// 64 x 32 fp32 store, a barrier and a load a tile; keeping the sums in
// shared memory (64 x d x 4 x 2 bytes an item) leaves no room for two K/V
// buffers and a ring at d = 256; two passes would read every tile twice.
// Registers a thread: dK's warpgroup holds dK (96 / 128), S^T and dP^T
// (16 + 16), the three ds terms (24) and a chunk's products (32): 184 /
// 216; the next tile's S^T and dP^T go to the tensor cores with the last
// chunk at 192 columns and after it at 256 (the same rule as dQ's,
// OVERLAP: at 256 the overlap spilled and ran slower, measured by
// tools/flash_bwd_overlap.py).  No instance spills (ptxas -v) since S^T's
// A descriptors are made where they are used (flash_bwd_sm90.cuh:opaque).
// Shared memory: K and V of an item 48 / 64 KB, two buffers,
// and a ring of (Q, dO) tiles with their lse and delta rows: 5 stages at
// 192 columns, 3 at 256.  Items go key block 0 first (the most query
// tiles), both warpgroups start at the first query tile that sees the
// block and write their 64 rows once.
#include "flash_bwd_sm90.cuh"

namespace {

// the head dims of this library
// (kernels/flash_attn.py:FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM and
// FLASH_BWD_SM90_MAX_HEAD_DIM)
constexpr int kMinHeadDim = 144, kMaxHeadDim = 256;

// ------------------------------------------------------------ #9: dK, dV
template <int HDP>
struct SplitCfg : DkdvPlan<HDP / 64, 64, 32> {
  // the next tile's S^T and dP^T issued with the last chunk (the registers)
  static constexpr bool OVERLAP = HDP <= 192;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_split_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int BH, int Sq, int Skv, int HD, float scale,
                          int causal, int q_offset) {
  using C = SplitCfg<HDP>;
  constexpr int BQ = C::BQ, BKB = C::BKB, NC = C::NC, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  const DkdvSmem<C> sm(smem_raw +
                       ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_items = BH * ((Skv + BKB - 1) / BKB);
  const int n_qt = (Sq + BQ - 1) / BQ;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (wg == kNWG) {
    dkdv_produce(sm, &tq, &tk, &tv, &tdo, lse, delta, BH, Sq, Skv, causal,
                 q_offset);
    return;
  }
  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int krow = 16 * warp + g;  // and krow + 8, in the item's 64 keys

  // warpgroup 0 (DK false): dV; warpgroup 1 (DK true): dK
  auto consume = [&](auto dk_tag) {
    constexpr bool DK = decltype(dk_tag)::value;
    int it0 = 0;  // query tiles consumed by this block before this item
    for (int w = blockIdx.x, k = 0; w < n_items; w += gridDim.x, ++k) {
      const int bh = w % BH, k0 = (w / BH) * BKB, b = k % C::KVBUF;
      const int t_first = sm.first_tile(k0, causal, q_offset);
      auto stage = [&](int t) { return (it0 + t - t_first) % NS; };
      auto phase = [&](int t) { return ((it0 + t - t_first) / NS) & 1; };

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
      mbar_wait(sm.kv(b), (k / C::KVBUF) & 1);
      const uint32_t k_base = smem_u32(sm.kvs + b * 2 * C::KV_BYTES);
      const uint32_t v_base = k_base + C::KV_BYTES;

      float sacc[BQ / 2], pacc[BQ / 2];
      uint32_t a[3][BQ / 16][4];
      // S^T = K Q^T (and for dK, dP^T = V dO^T) of the tile in stage st
      auto issue_st = [&](int st) {
        const uint32_t q_s = smem_u32(sm.ts + st * 2 * C::T_BYTES);
        const uint32_t do_s = q_s + C::T_BYTES;
        const uint32_t ka0 = opaque(k_base), va0 = opaque(v_base);
        fence_regs(sacc);
        if constexpr (DK) fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
          const uint32_t col = ks / 4, within = (ks % 4) * 32;
          const uint32_t ka = col * BKB * 128 + within;
          const uint32_t kb = col * BQ * 128 + within;
          wgmma_ss<BQ>(sacc, gmma_desc(ka0 + ka, 16, 1024),
                       gmma_desc(q_s + kb, 16, 1024), ks > 0);
          if constexpr (DK)
            wgmma_ss<BQ>(pacc, gmma_desc(va0 + ka, 16, 1024),
                         gmma_desc(do_s + kb, 16, 1024), ks > 0);
        }
      };
      auto st_done = [&] {
        fence_regs(sacc);
        if constexpr (DK) fence_regs(pacc);
      };
      // p^T into sacc (dV) or ds^T into pacc (dK); lse and delta by
      // column (query)
      auto grads_body = [&](auto masked_tag, int st, int t) {
        constexpr bool masked = decltype(masked_tag)::value;
        const float* rl = sm.rows + st * 2 * BQ;
        const int t0 = t * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rl + 8 * j + 2 * c4);
          float2 d2 = make_float2(0.0f, 0.0f);
          if constexpr (DK)
            d2 = *reinterpret_cast<const float2*>(rl + BQ + 8 * j + 2 * c4);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              const int qi = t0 + 8 * j + 2 * c4 + e;
              // __fmul_rn: s is rounded before the subtraction, never fused
              float s = __fmul_rn(scale, sacc[x]);
              if (masked && causal && k0 + krow + 8 * i > q_offset + qi)
                s = -1e30f;
              float p = expf(s - (e ? l2.y : l2.x));
              if (masked && qi >= Sq) p = 0.0f;
              if constexpr (DK)
                pacc[x] = p * (pacc[x] - (e ? d2.y : d2.x)) * scale;
              else
                sacc[x] = p;
            }
        }
      };
      auto grads = [&](int st, int t) {
        const int t0 = t * BQ;
        if ((causal && k0 + BKB - 1 > q_offset + t0) || t0 + BQ > Sq)
          grads_body(std::true_type(), st, t);
        else
          grads_body(std::false_type(), st, t);
      };

      // one query tile whose S^T (and dP^T) are in sacc (and pacc): dV +=
      // P^T dO or dK += dS^T Q, each 64-column chunk's products taken into
      // zeroed registers and added to the running sums in fp32
      // round-to-nearest; with `next`, the following tile's S^T (and dP^T)
      // go to the tensor cores with the last chunk (OVERLAP) or after it
      float tmp[32];
      auto tile = [&](auto next_tag, int t) {
        constexpr bool next = decltype(next_tag)::value;
        const int st = stage(t);
        const uint32_t q_s = smem_u32(sm.ts + st * 2 * C::T_BYTES);
        // B: Q for dK, dO for dV, read MN-major
        const uint32_t b_s = DK ? q_s : q_s + C::T_BYTES;
        grads(st, t);
        if constexpr (DK)
          split_frag<BQ>(pacc, a);
        else
          split_frag<BQ>(sacc, a);
        if constexpr (next && C::OVERLAP)
          mbar_wait(sm.full(stage(t + 1)), phase(t + 1));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          issue_chunk<BQ / 16, BQ>(tmp, a, b_s, c);
          if constexpr (next && C::OVERLAP)
            if (c == NC - 1) issue_st(stage(t + 1));
          wgmma_commit();
          wgmma_wait<0>();
          add_tile(acc[c], tmp, false);
        }
        if constexpr (next && C::OVERLAP) st_done();
        release(sm.empty(st));
        if constexpr (next && !C::OVERLAP) {
          mbar_wait(sm.full(stage(t + 1)), phase(t + 1));
          issue_st(stage(t + 1));
          wgmma_commit();
          wgmma_wait<0>();
          st_done();
        }
      };

      int t = t_first;
      if (t < n_qt) {
        mbar_wait(sm.full(stage(t)), phase(t));
        issue_st(stage(t));
        wgmma_commit();
        wgmma_wait<0>();
        st_done();
        for (; t + 1 < n_qt; ++t) tile(std::true_type(), t);
        tile(std::false_type(), t);
      }
      // every wgmma of this item has read its K and V
      release(sm.kvfree(b));
      it0 += max(0, n_qt - t_first);

      store_rows<NC>((DK ? dk : dv) + static_cast<size_t>(bh) * Skv * HD,
                     acc, k0, Skv, HD);
    }
  };
  if (wg == 0)
    consume(std::false_type());
  else
    consume(std::true_type());
}

}  // namespace

// dK, dV (BH, Skv, HD) bf16 from q, dO (BH, Sq, HD), k, v (BH, Skv, HD)
// bf16 and lse, delta (BH, Sq) float32; HD a multiple of 16 in [144, 256],
// q, k, v, dO 16-byte aligned (cudaErrorMisalignedAddress otherwise)
extern "C" int repro_flash_bwd_sm90_wide_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq,
    int Skv, int HD, float scale, int causal, int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, BH, Sq,
                           Skv, HD, scale, causal, q_offset, stream);
  if (int e = refuse(a, kMinHeadDim, kMaxHeadDim)) return e;
  return HD <= 192 ? launch_dkdv_with<SplitCfg<192>>(
                         flash_bwd_dkdv_split_sm90<192>, a)
                   : launch_dkdv_with<SplitCfg<256>>(
                         flash_bwd_dkdv_split_sm90<256>, a);
}

// dQ (BH, Sq, HD) bf16 from the same inputs
extern "C" int repro_flash_bwd_sm90_wide_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int BH, int Sq, int Skv,
    int HD, float scale, int causal, int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           BH, Sq, Skv, HD, scale, causal, q_offset, stream);
  if (int e = refuse(a, kMinHeadDim, kMaxHeadDim)) return e;
  return HD <= 192 ? launch_dq<192>(a) : launch_dq<256>(a);
}

// the largest head dim of this library, and of the tensor-core backward;
// tests hold kernels/flash_attn.py:FLASH_BWD_SM90_MAX_HEAD_DIM equal to it
extern "C" int repro_flash_bwd_sm90_wide_max_head_dim() { return kMaxHeadDim; }
