// W8A8 int8 matmul with the rank-1 dequant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py:int8_matmul (its body is
// _int8_matmul_kernel): y[m,n] = ((float)sum_k x[m,k]*w[k,n]) * g(rs[m]) *
// g(cs[n]), an int32 sum, g mapping a 0 scale to 1, the two products rounded
// in that order, cast to the carrier -- bit for bit ref.int8_matmul_ref.
// The decode linear also takes the fp activations and quantizes them per
// token inside the kernel (src/repro/kernels/ops.py:int8_prepared_linear,
// whose quantize_int runs ahead of the Pallas call in one XLA fusion).
//
// Bound: a serving linear at decode (M = 16 slots) reads the whole int8
// weight once for 16 MACs per byte, so it is bound by bytes (K*N at
// 3.35 TB/s: 0.2-0.7 us at GPT-2's widths, far below the ~2 us a launch
// costs); at prefill and in training (M in the thousands) by operations
// (2*M*N*K at 1,979 int8 TOP/s on the tensor cores) or, at (768, 768), by
// the bytes of x and y.
//
// Two routes, chosen by the wrapper (kernels/int8_matmul.py:fwd_route):
//  - M <= FWD_GEMV_MAX_M = 16 (the decode step), gemv_s8_kernel: one
//    launch, a split-K weight stream reduced in a thread-block cluster.  A
//    cluster of S blocks (S <= 8, the portable size) owns 32 output
//    columns; block s of it streams rows [s*ks, (s+1)*ks) of those columns,
//    so N = 768 gives 24 x S blocks and every block's whole slab (at most
//    256 rows a stage, two stages) is in flight by 16-byte cp.async before
//    it does anything else.  The fused entry then takes each row's partial
//    |x| max over its slice, exchanges the S partials through distributed
//    shared memory (the max is exact and order-free, so every block gets
//    the same row absmax), computes scale = fdiv_rn(max(absmax, 1e-12),
//    qmax) and quantizes its slice as clamp(rint(fdiv_rn(x, scale))) into
//    shared memory -- quantize_int's arithmetic, so scale and payload equal
//    the plain path's bit for bit.  A NaN is carried through the max, the
//    scale and the clamp as torch.amax and torch.clamp carry it, so a row
//    holding one gives NaN outputs, and a row holding an infinity NaN or
//    infinite ones, as the plain path does.  The int8 entry copies its xq
//    slice and takes rs as given.  The weight rows arrive (k, n)-major; a
//    pass of byte permutes packs four k bytes of one column into a word,
//    and mma.sync m16n8k32 s8 multiplies 16 rows (the decode step's 16
//    slots) by 8 columns by 32 k in one warp instruction, where __dp4a
//    needs 32.  Chosen by measurement: at M = 16 the kernel with mma.sync
//    products ran 3-6% faster than a variant with __dp4a ones (PERF.md),
//    and the bytes, not the products, bound it either way.  Each block
//    leaves its exact int32 (M x 32) partial in shared memory; after a
//    cluster barrier each block sums 1/S of the tile's outputs over the S
//    partials through distributed shared memory in rank order, applies
//    ((float)acc * g(rs)) * g(cs) and stores; a last barrier keeps every
//    block's shared memory alive until it has been read.  Integer sums:
//    every split count gives the same bits.  No workspace, no atomics.
//  - M above it, repro_int8_matmul_wgmma: the int8 tensor cores.  wgmma
//    takes 8-bit operands K-major only (the transpose bits exist for
//    16-bit types alone), and y = x.w contracts w's leading axis, so one
//    tiled transpose pass per call writes wT (N, pad16(K)) (transpose_kernel,
//    64 x 64 tiles through shared memory, zeros past K); x (M, K) is
//    already K-major (the wrapper pads a copy only where K is no multiple
//    of 16 bytes or x is off a 16-byte boundary).  Then gemm_s8.cuh's GEMM
//    (TMA ring, s8 wgmma, 128 x 128 tiles, two blocks an SM) with both
//    scales in its epilogue, split over the contraction with exact int32
//    partials and a fixed-order reduction where its tiles cannot fill the
//    card (the split count from the shapes, repro_int8_gemm_splits).  The
//    two or three kernels of a call chain by programmatic dependent launch;
//    the wrapper counts the call as one launch.
// The port's first kernel (int8_matmul_kernel, __dp4a on shared-memory
// tiles: one 256-thread block per 16 x 16 output tile at M <= 16, so 48
// blocks at N = 768, each walking the whole contraction with byte loads
// and no copy in flight during the arithmetic) is on no route: it stays as
// the yardstick the two routes are timed against.
// Edges masked, any N, K up to 131,071 (|sum| <= 128 * 128 * K < 2^31);
// the cluster route takes M <= 16 (one 16-row mma tile).
//
// Expert-batched instance (the MoE's experts: the reference's jax.vmap of
// policy.linear, which reaches this Pallas kernel through its batching
// rule): E products of one shape, x (E, M, K), w (E, K, N), rs (E, M), cs
// (E, N), out (E, M, N), in one launch of either route.  A grid dimension
// runs over the experts and each block offsets its pointers by its
// expert's; the transpose pass turns every expert's w in the same launch,
// and the GEMM reads the stacked operands through one TMA map each
// (gemm_s8.cuh).  Every expert's body and bits are the 2-D call's, and E =
// 1 is the 2-D call.  A first instance, not a redesign: routed by rows per
// expert as the 2-D call is by rows.
#include <cooperative_groups.h>

#include <type_traits>

#include "gemm_s8.cuh"

namespace {

// ------------------------------ the first CUDA-core kernel (no route)
template <int TM, int TN, int BK, typename OutT>
__global__ void __launch_bounds__(256)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ rs, const float* __restrict__ cs,
                   OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int KW = BK / 4;        // int32 words per tile row
  constexpr int KWP = KW + 1;       // padded stride: conflict-free columns
  __shared__ int32_t As[BM * KWP];  // [m][k] packed by 4
  __shared__ int32_t Bs[BN * KWP];  // [n][k] packed by 4 (transposed)
  int8_t* Ab = reinterpret_cast<int8_t*>(As);
  int8_t* Bb = reinterpret_cast<int8_t*>(Bs);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: neighbouring threads read neighbouring k bytes of one row
    for (int e = tid; e < BM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      Ab[r * KWP * 4 + c] =
          (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
    }
    // B tile: neighbouring threads read neighbouring n bytes of one k row,
    // stored transposed so four consecutive k of one column form a word
    for (int e = tid; e < BK * BN; e += 256) {
      const int c = e % BN, r = e / BN;
      const int gk = k0 + r, gn = n0 + c;
      Bb[c * KWP * 4 + r] =
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * KWP + kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[(tx + 16 * j) * KWP + kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float r = scale_guard(rs[gm]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float v = (static_cast<float>(acc[i][j]) * r) * scale_guard(cs[gn]);
      out[static_cast<size_t>(gm) * N + gn] = from_f32<OutT>(v);
    }
  }
}

template <int TM, int TN, int BK, typename OutT>
void launch_dp4a(const int8_t* x, const int8_t* w, const float* rs,
                 const float* cs, OutT* out, int M, int N, int K,
                 cudaStream_t stream) {
  dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  int8_matmul_kernel<TM, TN, BK, OutT><<<grid, 256, 0, stream>>>(
      x, w, rs, cs, out, M, N, K);
}

template <typename OutT>
void dispatch_dp4a(const int8_t* x, const int8_t* w, const float* rs,
                   const float* cs, OutT* out, int M, int N, int K,
                   cudaStream_t stream) {
  if (M <= 16)
    launch_dp4a<1, 1, 128>(x, w, rs, cs, out, M, N, K, stream);
  else
    launch_dp4a<4, 4, 32>(x, w, rs, cs, out, M, N, K, stream);
}

// ----------------------------------------------------------- wgmma route
// src (E, R, Cn) int8 -> dst (E, Cn, pad16(R)), zeros past R: one 64 x 64
// tile of expert blockIdx.z a block (gemm_s8.cuh:pack_t_tile)
__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                 int R, int Cn, int ldd, bool vec) {
  __shared__ uint32_t tile[64][17];
  const size_t e = blockIdx.z;
  pack_t_tile<int8_t, false>(src + e * R * Cn, nullptr, nullptr,
                             dst + e * Cn * ldd, R, Cn, ldd, vec,
                             blockIdx.y * 64, blockIdx.x * 64, tile);
}

int transpose(const void* src, void* dst, int R, int Cn, cudaStream_t st,
              int experts = 1) {
  if (R < 1 || Cn < 1 || experts < 1 || experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // vec (4-byte loads): every row of every expert 4-byte aligned
  const bool vec = Cn % 4 == 0 && aligned16(src);
  return launch_pdl(transpose_kernel,
                    dim3(ceil_div(Cn, 64), ceil_div(R, 64), experts),
                    dim3(256), 0, st, static_cast<const int8_t*>(src),
                    static_cast<int8_t*>(dst), R, Cn, pad_to16(R), vec);
}

// ---------------------------------------------------------- cluster route
namespace cg = cooperative_groups;

constexpr int kGvBN = 32;          // output columns of a cluster
constexpr int kGvKC = 256;         // weight rows of a stage
constexpr int kGvStages = 2;       // stages in flight
constexpr int kGvRows = 16;        // rows of the mma tile: the most M
constexpr int kGvThreads = 128;    // four warps: one 8-column group each
constexpr int kGvMaxSplits = 8;    // the portable cluster size
constexpr int kGvStep = 32;        // contraction of one mma.sync
constexpr int kGvWords = kGvKC / 4 + 4;  // packed row stride, 4 mod 32 words
constexpr int kGvPS = kGvBN + 8;   // partial row stride (int32)

struct GemvSmem {
  // the raw weight stages, (kGvKC, kGvBN) row-major each; the int32
  // partials (kGvRows, kGvPS) reuse them once the products are done
  alignas(16) int8_t w[kGvStages][kGvKC * kGvBN];
  // the stage packed four k bytes of a column a word, [n][kGvWords]
  uint32_t bt[kGvBN * kGvWords];
  // the activation payloads, (kGvRows, kGvKC) int8 as [m][kGvWords] words
  uint32_t xq[kGvRows * kGvWords];
  float rowmax[kGvRows];           // this block's partial |x| max per row
  float rscale[kGvRows];           // the fused entry's row scales
};
static_assert(sizeof(int) * kGvRows * kGvPS <= kGvStages * kGvKC * kGvBN,
              "the partials fit the weight stages");

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// rows [kc0, kc0 + kGvKC) x columns [n0, n0 + kGvBN) of w (ldw bytes a row,
// 16-byte aligned) into a stage: 16-byte copies, zeros past k_hi and ldw
__device__ __forceinline__ void load_w_stage(int8_t* dst,
                                             const int8_t* __restrict__ w,
                                             int ldw, int n0, int kc0,
                                             int k_hi) {
  for (int it = threadIdx.x; it < kGvKC * 2; it += kGvThreads) {
    const int r = it / 2, col = n0 + 16 * (it % 2), k = kc0 + r;
    const bool ok = k < k_hi && col < ldw;
    cp_async16_zfill(dst + 16 * it,
                     ok ? w + static_cast<size_t>(k) * ldw + col : w,
                     ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// eight payload bytes of row p from k, 0 past k_end: the int8 entry's
// activations as they are, the fused entry's quantized by quantize_int's
// arithmetic, clamp(rint(x / scale), qmin, qmax) with an IEEE division; the
// clamp keeps a NaN, as torch.clamp does, and the cast takes it to 0, as
// the card's float -> int8 cast does
template <typename XT>
__device__ __forceinline__ uint2 payload8(const XT* __restrict__ p, int k,
                                          int k_end, bool vec, float scale,
                                          float qmin, float qmax) {
  uint32_t b[2] = {0u, 0u};
  if constexpr (std::is_same<XT, int8_t>::value) {
    if (vec && k < k_end) return *reinterpret_cast<const uint2*>(p + k);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (k + e < k_end)
        b[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[k + e]))
                    << (8 * (e % 4));
  } else {
    float v[8];
    load8(p, k, k_end, vec, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float q =
          min_nan(max_nan(rintf(__fdiv_rn(v[e], scale)), qmin), qmax);
      b[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      static_cast<int8_t>(static_cast<int>(q))))
                  << (8 * (e % 4));
    }
  }
  return make_uint2(b[0], b[1]);
}

// d (16 x 8, int32) += a (16 x 32, s8, row-major) . b (32 x 8, s8, by column)
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// y (M, N) for M <= kGvRows, one cluster of gridDim.x blocks per 32 output
// columns (blockIdx.y) of expert blockIdx.z (x, w, rs, cs and out hold
// gridDim.z experts' (M, K), (K, ldw), (M), (N) and (M, N) back to back);
// ks: contraction rows per block, a multiple of 32.
// XT int8_t: x is the int8 payload and rs its row scales; XT float or
// bf16: x is quantized per row here (qmin, qmax) and rs is unused.  vec:
// K % 8 == 0 and x 16-byte aligned, so x loads as vectors.
template <typename XT, typename OutT>
__global__ void __launch_bounds__(kGvThreads)
gemv_s8_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ rs, const float* __restrict__ cs,
               OutT* __restrict__ out, int M, int N, int K, int ldw, int ks,
               float qmin, float qmax, bool vec) {
  constexpr bool kQuant = !std::is_same<XT, int8_t>::value;
  __shared__ GemvSmem s;
  {
    const size_t e = blockIdx.z;
    x += e * M * K;
    w += e * K * ldw;
    if (!kQuant) rs += e * M;
    cs += e * N;
    out += e * M * N;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * kGvBN;
  const int k_lo = min(rank * ks, K), k_hi = min(k_lo + ks, K);
  const int n_chunks = (k_hi - k_lo + kGvKC - 1) / kGvKC;

  // 1. the weight stream first: every stage's slab in flight
#pragma unroll
  for (int c = 0; c < kGvStages; ++c) {
    if (c < n_chunks)
      load_w_stage(s.w[c], w, ldw, n0, k_lo + c * kGvKC, k_hi);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // 2. the fused entry's row scales: partial |x| max over this block's
  //    slice, a warp a row, then the cluster's max through DSMEM (NaN
  //    propagating, as torch.amax and torch.clamp_min)
  if constexpr (kQuant) {
    for (int m = warp; m < M; m += kGvThreads / 32) {
      const XT* row = x + static_cast<size_t>(m) * K;
      float mx = 0.0f;
      for (int k = k_lo + 8 * lane; k < k_hi; k += 256) {
        float v[8];
        load8(row, k, k_hi, vec, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) mx = max_nan(mx, fabsf(v[e]));
      }
      mx = warp_max_nan(mx);
      if (lane == 0) s.rowmax[m] = mx;
    }
    cluster.sync();
    if (tid < M) {
      float mx = 0.0f;
      for (int q = 0; q < splits; ++q)
        mx = max_nan(mx, *cluster.map_shared_rank(&s.rowmax[tid], q));
      s.rscale[tid] = __fdiv_rn(max_nan(mx, 1e-12f), qmax);
    }
    __syncthreads();
  }

  // 3. the products, a stage at a time, into the warp's mma fragment
  const int g = lane / 4, tig = lane % 4;
  int acc[4] = {0, 0, 0, 0};
  for (int c = 0; c < n_chunks; ++c) {
    const int kc0 = k_lo + c * kGvKC;
    const int steps = (min(kGvKC, k_hi - kc0) + kGvStep - 1) / kGvStep;
    const int groups = steps * kGvStep / 8;  // 8-byte groups of a row
    for (int it = tid; it < kGvRows * groups; it += kGvThreads) {
      const int m = it / groups, q = it % groups;
      uint2 v = make_uint2(0u, 0u);
      if (m < M)
        v = payload8(x + static_cast<size_t>(m) * K, kc0 + 8 * q, k_hi, vec,
                     kQuant ? s.rscale[m] : 1.0f, qmin, qmax);
      *reinterpret_cast<uint2*>(&s.xq[m * kGvWords + 2 * q]) = v;
    }
    cp_async_wait_group<kGvStages - 1>();
    __syncthreads();
    // four rows x four columns of the stage -> four k-packed column words
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(s.w[c % kGvStages]);
    for (int it = tid; it < steps * 8 * (kGvBN / 4); it += kGvThreads) {
      const int c4 = it % (kGvBN / 4), k4 = it / (kGvBN / 4);
      const uint32_t* src = ws + 4 * k4 * (kGvBN / 4) + c4;
      const uint32_t r0 = src[0], r1 = src[kGvBN / 4];
      const uint32_t r2 = src[2 * (kGvBN / 4)], r3 = src[3 * (kGvBN / 4)];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int i = 0; i < 4; ++i) s.bt[(4 * c4 + i) * kGvWords + k4] = o[i];
    }
    __syncthreads();
    if (c + kGvStages < n_chunks)
      load_w_stage(s.w[c % kGvStages], w, ldw, n0, kc0 + kGvStages * kGvKC,
                   k_hi);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    // warp w: columns 8w..8w+7 of the 16-row tile
    for (int j = 0; j < steps; ++j) {
      const uint32_t* bp = &s.bt[(8 * warp + g) * kGvWords + 8 * j + tig];
      const uint32_t* ap = &s.xq[g * kGvWords + 8 * j + tig];
      mma_s8_16832(acc, ap[0], ap[8 * kGvWords], ap[4], ap[8 * kGvWords + 4],
                   bp[0], bp[4]);
    }
    __syncthreads();
  }
  cp_async_wait_group<0>();
  __syncthreads();

  // 4. this block's int32 partial into shared memory (over the stages)
  int* part = reinterpret_cast<int*>(s.w);
  const int col = 8 * warp + 2 * tig;
  *reinterpret_cast<int2*>(&part[g * kGvPS + col]) = make_int2(acc[0], acc[1]);
  *reinterpret_cast<int2*>(&part[(g + 8) * kGvPS + col]) =
      make_int2(acc[2], acc[3]);
  cluster.sync();

  // 5. block `rank` sums outputs rank*128 + tid, + splits*128, ... of the
  //    tile over the cluster's partials in rank order, then the epilogue
  for (int o = rank * kGvThreads + tid; o < M * kGvBN;
       o += splits * kGvThreads) {
    const int m = o / kGvBN, n = o % kGvBN;
    if (n0 + n >= N) continue;
    int sum = 0;
    for (int q = 0; q < splits; ++q)
      sum += cluster.map_shared_rank(part, q)[m * kGvPS + n];
    const float r = scale_guard(kQuant ? s.rscale[m] : rs[m]);
    out[static_cast<size_t>(m) * N + n0 + n] = from_f32<OutT>(
        __fmul_rn(__fmul_rn(static_cast<float>(sum), r),
                  scale_guard(cs[n0 + n])));
  }
  cluster.sync();  // no block leaves while its partial may still be read
}

template <typename XT, typename OutT>
int launch_gemv(const void* x, const void* w, const float* rs,
                const float* cs, void* out, int M, int N, int K, int ldw,
                int splits, float qmin, float qmax, int experts,
                cudaStream_t st) {
  const int ks = ceil_div(ceil_div(K, splits), kGvStep) * kGvStep;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, ceil_div(N, kGvBN), experts);
  cfg.blockDim = dim3(kGvThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gemv_s8_kernel<XT, OutT>, static_cast<const XT*>(x),
      static_cast<const int8_t*>(w), rs, cs, static_cast<OutT*>(out), M, N,
      K, ldw, ks, qmin, qmax, K % 8 == 0 && aligned16(x)));
}

template <typename XT>
int gemv_out(const void* x, const void* w, const float* rs, const float* cs,
             void* out, int M, int N, int K, int ldw, int splits, float qmin,
             float qmax, int out_dtype, int experts, cudaStream_t st) {
  if (out_dtype == kFloat32)
    return launch_gemv<XT, float>(x, w, rs, cs, out, M, N, K, ldw, splits,
                                  qmin, qmax, experts, st);
  if (out_dtype == kBFloat16)
    return launch_gemv<XT, __nv_bfloat16>(x, w, rs, cs, out, M, N, K, ldw,
                                          splits, qmin, qmax, experts, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ------------------------------------------------------------- the routes
// The cluster route: x (M, K) contiguous, int8 (x_dtype 2, the payload,
// with its row scales rs (M) f32) or float32 / bfloat16 (x_dtype 0 / 1,
// quantized per row to `bits` bits here; rs unused); w (K, N) int8 with rows
// ldw bytes apart (ldw a multiple of 16 and >= N, w 16-byte aligned); cs
// (N) f32; out (M, N) in out_dtype.  M <= 16, splits in [1, 8]: the
// cluster size.  experts > 1: that many such products back to back in
// every operand (x (E, M, K), w (E, K, ldw), rs (E, M), cs (E, N), out (E,
// M, N)), one launch.
extern "C" int repro_int8_gemv(const void* x, const void* w, const void* rs,
                               const void* cs, void* out, int M, int N, int K,
                               int ldw, int splits, int x_dtype,
                               int out_dtype, int bits, int experts,
                               void* stream) {
  if (M < 1 || M > kGvRows || N < 1 || K < 1 || K > kMaxContraction ||
      splits < 1 || splits > kGvMaxSplits || ldw % 16 || ldw < N ||
      !aligned16(w) || bits < 2 || bits > 8 || experts < 1 ||
      experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const float*>(rs);
  auto cp = static_cast<const float*>(cs);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float qmin = -static_cast<float>(1 << (bits - 1));
  int rc;
  if (x_dtype == 2)
    rc = gemv_out<int8_t>(x, w, rp, cp, out, M, N, K, ldw, splits, qmin,
                          qmax, out_dtype, experts, st);
  else if (x_dtype == kFloat32)
    rc = gemv_out<float>(x, w, rp, cp, out, M, N, K, ldw, splits, qmin, qmax,
                         out_dtype, experts, st);
  else if (x_dtype == kBFloat16)
    rc = gemv_out<__nv_bfloat16>(x, w, rp, cp, out, M, N, K, ldw, splits,
                                 qmin, qmax, out_dtype, experts, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// x (M, K) int8, w (K, N) int8, rs (M) f32, cs (N) f32, all contiguous;
// out (M, N) in the carrier (out_dtype: 0 float32, 1 bfloat16).  The
// first CUDA-core kernel at any M (16 x 16 tiles at M <= 16, 64 x 64 above).
extern "C" int repro_int8_matmul_dp4a(const void* x, const void* w,
                                      const void* rs, const void* cs,
                                      void* out, int M, int N, int K,
                                      int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto rp = static_cast<const float*>(rs);
  auto cp = static_cast<const float*>(cs);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == kFloat32)
    dispatch_dp4a(xp, wp, rp, cp, static_cast<float*>(out), M, N, K, s);
  else if (out_dtype == kBFloat16)
    dispatch_dp4a(xp, wp, rp, cp, static_cast<__nv_bfloat16*>(out), M, N, K,
                  s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: x (M, ldx) int8 K-major (ldx a multiple of 16,
// 16-byte aligned, the first K bytes of a row the payload), w (K, N) int8
// contiguous, rs (M) and cs (N) f32; wt (N, pad16(K)) int8 and ws (splits,
// M, N) int32 (splits > 1 only) the wrapper's buffers; out (M, N) in
// out_dtype.  The transpose pass, the GEMM, and the split reduction where
// it splits.  experts > 1: that many such products back to back in every
// operand and buffer (x (E, M, ldx), w (E, K, N), rs (E, M), cs (E, N), wt
// (E, N, pad16(K)), ws (splits, E, M, N), out (E, M, N)).
extern "C" int repro_int8_matmul_wgmma(const void* x, const void* w,
                                       const void* rs, const void* cs,
                                       void* out, void* wt, void* ws, int M,
                                       int N, int K, int ldx, int splits,
                                       int out_dtype, int experts,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = transpose(w, wt, K, N, st, experts)) return e;
  return gemm_out<kBothScales>(out_dtype, x, wt,
                               static_cast<const float*>(rs),
                               static_cast<const float*>(cs), out, ws, M, N,
                               K, ldx, pad_to16(K), splits, st, experts);
}

// ------------------------------------------------------------- the stages
// src (R, Cn) int8 contiguous -> dst (Cn, pad16(R)) int8, zeros past R
extern "C" int repro_int8_transpose(const void* src, void* dst, int R, int Cn,
                                    void* stream) {
  return transpose(src, dst, R, Cn, static_cast<cudaStream_t>(stream));
}

// a (R, lda), b (C, ldb) int8 K-major (lda, ldb multiples of 16, 16-byte
// aligned), contraction Kc, rs (R) and cs (C) f32.  splits == 1: out (R, C)
// = cast((float(sum) * g(rs)) * g(cs)) in out_dtype; splits > 1: each
// split's int32 partial sums into ws (splits, R, C), out and the scales
// unused.
extern "C" int repro_int8_gemm_fwd(const void* a, const void* b,
                                   const void* rs, const void* cs, void* out,
                                   void* ws, int R, int C, int Kc, int lda,
                                   int ldb, int splits, int out_dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1)
    return launch_gemm<kBothScales, float>(a, b, nullptr, nullptr, out, ws, R,
                                           C, Kc, lda, ldb, splits, st);
  return gemm_out<kBothScales>(out_dtype, a, b, static_cast<const float*>(rs),
                               static_cast<const float*>(cs), out, nullptr, R,
                               C, Kc, lda, ldb, 1, st);
}

// ws (S, R, C) int32 -> out (R, C) = cast((float(sum over S) * g(rs)) *
// g(cs))
extern "C" int repro_int8_split_reduce_fwd(const void* ws, const void* rs,
                                           const void* cs, void* out, int R,
                                           int C, int S, int out_dtype,
                                           void* stream) {
  return reduce_out<kBothScales>(out_dtype, ws, static_cast<const float*>(rs),
                                 static_cast<const float*>(cs), out, R, C, S,
                                 static_cast<cudaStream_t>(stream));
}

// the split count the tensor-core route expects for an (R, C) output over a
// contraction of Kc, for each of `experts` such products in one launch (the
// wrapper sizes the workspace by it)
extern "C" int repro_int8_gemm_splits(int R, int C, int Kc, int experts) {
  return gemm_splits(R, C, Kc, experts);
}
