// The s8 tensor-core GEMM of two K-major int8 operands with a rank-1
// dequant epilogue, and the tiled int8 transpose that makes an operand
// K-major -- shared by the W8A8 forward (int8_matmul.cu) and the training
// backward (int8_matmul_bwd.cu), for Hopper (sm_90a).
//
//   C[i, j] = cast(s(float(sum_k A[i, k] B[j, k])))
//
// A (R, lda) and B (C, ldb) int8, K-major (lda, ldb multiples of 16 bytes,
// 16-byte aligned), an exact int32 sum over a contraction of at most
// kMaxContraction (|sum| <= 128 * 128 * Kc < 2^31), and s the scale mode:
//   kRowScale   s(v) = v * g(rs[i])                 (nt: the token's scale)
//   kColScale   s(v) = v * g(cs[j])                 (tn: the channel's scale)
//   kBothScales s(v) = (v * g(rs[i])) * g(cs[j])   (the forward)
// with g mapping a 0 scale to 1 and each product rounded to nearest in the
// order written (two roundings in the forward: one rs * cs factor would
// change bits).  (float)sum is exact below 2^24 and rounded to nearest once
// above, as the plain versions' cast is.
//
// Design: 128 x 128 output tiles in 128-byte contraction steps; a producer
// warp streams the A and B tiles by TMA (2-D maps, 128-byte swizzle; the
// hardware fills zeros past every edge, so a ragged R, C or contraction
// needs no code) into a 3-stage mbarrier ring; two consumer warpgroups each
// run wgmma m64n128k32.s32.s8.s8 into int32 registers, one group in flight
// while the next is issued.  Two blocks share an SM, so one block's
// epilogue runs under the other's products.  Where the
// output tiles cannot fill the card the contraction splits: each split
// writes its exact int32 partial tile to a workspace, and split_reduce_kernel
// adds the splits in a fixed order and applies the epilogue once.  Integer
// addition is associative, so every split count gives the same bits, run
// after run; there are no atomics.  Every kernel waits on the one before it
// (griddepcontrol.wait), so a call's kernels chain by programmatic dependent
// launch.
//
// Expert-batched instance (the MoE's vmap): E independent products of the
// same shape in one launch, A (E * R, lda) and B (E * C, ldb) stacked by
// expert, the scales rs (E, R) and cs (E, C), the output (E, R, C).  The
// grid's z runs over (expert, split) pairs; a block's tiles start at row
// e * R + i0 of A and e * C + j0 of B, so the TMA boxes of an expert's
// ragged last tile read the next expert's rows (or zeros past the last),
// whose products land in rows and columns the epilogue never stores.  Each
// expert's body and bits are the 2-D call's; E = 1 is the 2-D call.
#pragma once

#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxContraction = 131071;

enum ScaleMode { kRowScale = 0, kColScale = 1, kBothScales = 2 };

// ------------------------------------------------ quantize and transpose
__device__ __forceinline__ int8_t quant_g(float g, float fold, float qs) {
  float r = rintf(__fdiv_rn(__fmul_rn(g, fold), qs));
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// four consecutive elements from a 4-element-aligned address
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ float as_f32(T x) { return to_f32(x); }
template <>
__device__ __forceinline__ float as_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// eight consecutive values of a row as floats: one or two vector loads
// (vec) or element by element, 0 past n_end
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n0, int n_end, bool vec,
                                      float (&v)[8]) {
  if (vec && n0 < n_end) {
    const Vec4<T> lo = *reinterpret_cast<const Vec4<T>*>(p + n0);
    const Vec4<T> hi = *reinterpret_cast<const Vec4<T>*>(p + n0 + 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = to_f32(lo.v[e]);
      v[e + 4] = to_f32(hi.v[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = n0 + e < n_end ? to_f32(p[n0 + e]) : 0.0f;
  }
}

// a (R, Cn) source into its K-major transpose dst (Cn, ldd): dst[c, r] =
// quant_g(src[r, c], fold[r], g(qs[c])) (QUANT, tn's gradient) or src[r, c]
// (an int8 payload) for r < R, and 0 for R <= r < ldd.  A block of 256
// threads turns the 64 x 64 tile (r0, c0): each thread loads 4 rows x 4
// columns, packs each column's 4 rows into one word of shared memory, and
// the tile leaves as 16-byte row segments of dst.  vec: Cn % 4 == 0 and src
// 16-byte aligned, so each thread's 4 columns load as one vector.
template <typename T, bool QUANT>
__device__ __forceinline__ void pack_t_tile(
    const T* __restrict__ src, const float* __restrict__ fold,
    const float* __restrict__ qs, int8_t* __restrict__ dst, int R, int Cn,
    int ldd, bool vec, int r0, int c0, uint32_t (&tile)[64][17]) {
  const int t = threadIdx.x, cq = t % 16, rq = t / 16;
  const int cb = c0 + 4 * cq;  // this thread's first column
  grid_dependency_wait();
  float cs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cs[i] = QUANT && cb + i < Cn ? scale_guard(qs[cb + i]) : 1.0f;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 4 * rq + j;
    if (r >= R) continue;
    const T* row = src + static_cast<size_t>(r) * Cn;
    float v[4];
    if (vec && cb < Cn) {
      const Vec4<T> q = *reinterpret_cast<const Vec4<T>*>(row + cb);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = as_f32(q.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = cb + i < Cn ? as_f32(row[cb + i]) : 0.0f;
    }
    const float fr = QUANT ? fold[r] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int8_t b = 0;
      if (cb + i < Cn)
        b = QUANT ? quant_g(v[i], fr, cs[i]) : static_cast<int8_t>(v[i]);
      w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(b)) << (8 * j);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tile[4 * cq + i][rq] = w[i];
  __syncthreads();
  const int c = t / 4, q = t % 4;
  if (c0 + c < Cn && r0 + 16 * q < ldd) {
    const uint4 o = make_uint4(tile[c][4 * q], tile[c][4 * q + 1],
                               tile[c][4 * q + 2], tile[c][4 * q + 3]);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(c0 + c) * ldd + r0 +
                              16 * q) = o;
  }
}

// ----------------------------------------------------------------- GEMM
constexpr int kBM = 128;  // output rows per block: two warpgroups of 64
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 128;  // contraction bytes per stage: one swizzle row
constexpr int kStages = 3;
constexpr int kTileA = kBM * kBK;
constexpr int kTileB = kBN * kBK;
// two consumer warpgroups and one producer warp; two blocks per SM, so
// each thread may hold 65536 / 576 registers (no setmaxnreg: its budget
// would be shared by both blocks of the SM)
constexpr int kGemmThreads = 288;
constexpr int kGemmSmem = kStages * (kTileA + kTileB) + 1024 + 64;
static_assert(2 * (kGemmSmem + 1024) <= 233472, "two blocks must fit an SM");

#define R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
    "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (m64 x n128, int32) += A (smem, K-major) . B (smem, K-major), k = 32
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(a), "l"(b), "r"(1));
}
#undef R8

// two adjacent outputs (c, c + 1) of one row; pair: the row length is
// even, so the two share one aligned store
template <typename T>
__device__ __forceinline__ void store2(T* p, T v0, T v1, bool ok1, bool pair);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1,
                                              bool ok1, bool pair) {
  if (pair && ok1) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else { p[0] = v0; if (ok1) p[1] = v1; }
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      __nv_bfloat16 v0,
                                                      __nv_bfloat16 v1,
                                                      bool ok1, bool pair) {
  if (pair && ok1) *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(v0, v1);
  else { p[0] = v0; if (ok1) p[1] = v1; }
}
template <>
__device__ __forceinline__ void store2<int>(int* p, int v0, int v1, bool ok1,
                                            bool pair) {
  if (pair && ok1) *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  else { p[0] = v0; if (ok1) p[1] = v1; }
}

// the epilogue of one sum: (float)acc, then the row scale (guarded, r_s),
// then the column scale, each multiply rounded to nearest on its own
template <int MODE>
__device__ __forceinline__ float dequant(int acc, float r_s, float c_s) {
  float v = __int2float_rn(acc);
  if (MODE != kColScale) v = __fmul_rn(v, r_s);
  if (MODE != kRowScale) v = __fmul_rn(v, c_s);
  return v;
}

// grid (C tiles, R tiles, experts * splits): block z is split z % splits of
// expert z / splits, and sums contraction steps [s * kps, min((s + 1) *
// kps, n_kb)) of 128 bytes (s = z % splits).  ws == nullptr: the
// dequantized output; else split s's int32 partial sums into ws[s][e] (R,
// C) of a (splits, E, R, C) workspace.  rs (E, R) is read in the row and
// both modes, cs (E, C) in the column and both modes; R and C are an
// expert's.
template <int MODE, typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_s8_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ rs, const float* __restrict__ cs,
               OutT* __restrict__ out, int* __restrict__ ws, int R, int C,
               int kps, int n_kb, int splits) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* as = smem;                       // kStages x [128 rows][128 B]
  uint8_t* bs = as + kStages * kTileA;      // kStages x [128 rows][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(bs + kStages * kTileB);
  auto bar_full = [&](int s) { return smem_u32(bars + s); };
  auto bar_empty = [&](int s) { return smem_u32(bars + kStages + s); };

  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int e = blockIdx.z / splits, split = blockIdx.z % splits;
  const int experts = gridDim.z / splits;
  const int kb0 = split * kps;
  const int nk = min(n_kb, kb0 + kps) - kb0;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the operands (and the scales) come from the kernels before this one
  grid_dependency_wait();

  if (warp == 8) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 256) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), kTileA + kTileB);
        const int k = (kb0 + t) * kBK;
        tma_load_2d(smem_u32(as + s * kTileA), &ta, bar_full(s), k,
                    e * R + i0);
        tma_load_2d(smem_u32(bs + s * kTileB), &tb, bar_full(s), k,
                    e * C + j0);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int wg = warp / 4, lane = threadIdx.x % 32;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    mbar_wait(bar_full(s), (t / kStages) & 1);
    const uint32_t a = smem_u32(as + s * kTileA) + wg * 64 * kBK;
    const uint32_t b = smem_u32(bs + s * kTileB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_n128(acc, gmma_desc(a + 32 * kk, 16, 1024),
                    gmma_desc(b + 32 * kk, 16, 1024));
    wgmma_commit();
    // the previous stage's products are done: hand its tiles back
    wgmma_wait<1>();
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty((t - 1) % kStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + 2i + e] holds row 16 (warp % 4) + lane / 4 + 8i of this
  // warpgroup's 64, column 8j + 2 (lane % 4) + e
  const bool pair = C % 2 == 0;
  const size_t rc = static_cast<size_t>(R) * C;
  int* part = ws != nullptr
                  ? ws + (static_cast<size_t>(split) * experts + e) * rc
                  : nullptr;
  if (part == nullptr) out += e * rc;
  if (rs != nullptr) rs += static_cast<size_t>(e) * R;
  if (cs != nullptr) cs += static_cast<size_t>(e) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * i;
    if (r >= R) continue;
    const float r_s =
        MODE != kColScale && part == nullptr ? scale_guard(rs[r]) : 1.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = j0 + 8 * j + 2 * (lane % 4);
      if (c >= C) continue;
      const bool ok1 = c + 1 < C;
      const int v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      const size_t at = static_cast<size_t>(r) * C + c;
      if (part != nullptr) {
        store2<int>(part + at, v0, v1, ok1, pair);
      } else {
        const float c0 = MODE != kRowScale ? scale_guard(cs[c]) : 1.0f;
        const float c1 =
            MODE != kRowScale && ok1 ? scale_guard(cs[c + 1]) : 1.0f;
        store2<OutT>(out + at, from_f32<OutT>(dequant<MODE>(v0, r_s, c0)),
                     from_f32<OutT>(dequant<MODE>(v1, r_s, c1)), ok1, pair);
      }
    }
  }
}

// out[r, c] = cast(dequant(sum_z ws[z, r, c])), the splits added in order
// z = 0, 1, ... (exact int32); four outputs a thread, read as one vector of
// each split where R * C % 4 == 0.  R counts every expert's rows; row r is
// expert r / Re's, whose column scales start at cs + (r / Re) * C (Re = R
// for one expert)
template <int MODE, typename OutT>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const int* __restrict__ ws, const float* __restrict__ rs,
                    const float* __restrict__ cs, OutT* __restrict__ out,
                    int R, int C, int S, int Re) {
  const size_t n = static_cast<size_t>(R) * C;
  const size_t i0 = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i0 >= n) return;
  grid_dependency_wait();
  int sum[4] = {0, 0, 0, 0};
  if (n % 4 == 0) {
    for (int z = 0; z < S; ++z) {
      const int4 v = *reinterpret_cast<const int4*>(ws + z * n + i0);
      sum[0] += v.x; sum[1] += v.y; sum[2] += v.z; sum[3] += v.w;
    }
  } else {
    for (int z = 0; z < S; ++z)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < n) sum[e] += ws[z * n + i0 + e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t idx = i0 + e;
    if (idx >= n) break;
    const int r = static_cast<int>(idx / C), c = static_cast<int>(idx % C);
    const float r_s = MODE != kColScale ? scale_guard(rs[r]) : 1.0f;
    const float c_s =
        MODE != kRowScale ? scale_guard(cs[static_cast<size_t>(r / Re) * C + c])
                          : 1.0f;
    out[idx] = from_f32<OutT>(dequant<MODE>(sum[e], r_s, c_s));
  }
}

// ----------------------------------------------------------------- host
inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int pad_to16(int n) { return ceil_div(n, 16) * 16; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// an int8 (rows, inner) operand with rows ld bytes apart as a 2-D map,
// boxes of 128 bytes x box_rows; zero fill past inner and rows
inline bool make_map(CUtensorMap* map, const void* base, int inner, int rows,
                     int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !aligned16(base) || ld % 16 || ld < inner) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// splits of the contraction for an (R, C) output over Kc, for each of
// `experts` such products in one launch: the count that minimises a cost
// model -- the busiest SM's 128-byte steps (two blocks share an SM) plus
// the workspace's bytes -- at least two steps a split
inline int gemm_splits(int R, int C, int Kc, int experts = 1) {
  const int n_sm = sm_count() > 0 ? sm_count() : 132;
  const long tiles = static_cast<long>(ceil_div(R, kBM)) * ceil_div(C, kBN) *
                     experts;
  const int n_kb = ceil_div(Kc, kBK);
  // one step of one 128 x 128 tile on an SM, and the workspace's rate, in
  // microseconds and bytes per microsecond (H100 readings, rounded)
  const double t_step = 0.45, bw = 2.5e6;
  int best = 1;
  double best_cost = 1e300;
  for (int s = 1; s <= 16 && s <= n_kb; ++s) {
    const int kps = ceil_div(n_kb, s);
    if (ceil_div(n_kb, kps) != s || (s > 1 && kps < 2)) continue;
    const double waves = static_cast<double>((tiles * s + n_sm - 1) / n_sm);
    double cost = waves * kps * t_step;
    if (s > 1) cost += (2.0 * s + 1.0) * 4.0 * R * C * experts / bw;
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// validates the split count: splits blocks of kps steps, none empty
inline bool split_steps(int Kc, int splits, int* kps) {
  const int n_kb = ceil_div(Kc, kBK);
  if (splits < 1 || splits > n_kb) return false;
  *kps = ceil_div(n_kb, splits);
  return ceil_div(n_kb, *kps) == splits;
}

template <typename K>
int prepare_gemm(K kern) {
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem));
  if (e) return e;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared)));
}

// one GEMM launch: the dequantized output (splits == 1) or the int32
// partials of each split into ws; `experts` products of (R, C) stacked by
// expert (see the top of this file)
template <int MODE, typename OutT>
int launch_gemm(const void* a, const void* b, const float* rs,
                const float* cs, void* out, void* ws, int R, int C, int Kc,
                int lda, int ldb, int splits, cudaStream_t st,
                int experts = 1) {
  int kps = 0;
  if (R < 1 || C < 1 || Kc < 1 || Kc > kMaxContraction || experts < 1 ||
      static_cast<long>(R) * experts > INT_MAX ||
      static_cast<long>(C) * experts > INT_MAX ||
      static_cast<long>(splits) * experts > 65535 ||
      !split_steps(Kc, splits, &kps) || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, Kc, R * experts, lda, kBM) ||
      !make_map(&tb, b, Kc, C * experts, ldb, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gemm_s8_kernel<MODE, OutT>;
  static const int prepared = prepare_gemm(kern);  // once per instance
  if (prepared) return prepared;
  return launch_pdl(kern,
                    dim3(ceil_div(C, kBN), ceil_div(R, kBM), splits * experts),
                    dim3(kGemmThreads), kGemmSmem, st, ta, tb, rs, cs,
                    static_cast<OutT*>(out),
                    splits > 1 ? static_cast<int*>(ws) : nullptr, R, C, kps,
                    ceil_div(Kc, kBK), splits);
}

template <int MODE, typename OutT>
int launch_reduce(const void* ws, const float* rs, const float* cs, void* out,
                  int R, int C, int S, cudaStream_t st, int experts = 1) {
  if (R < 1 || C < 1 || S < 1 || experts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(R) * C * experts;
  return launch_pdl(split_reduce_kernel<MODE, OutT>,
                    dim3(static_cast<unsigned>((n + 1023) / 1024)), dim3(256),
                    0, st, static_cast<const int*>(ws), rs, cs,
                    static_cast<OutT*>(out), R * experts, C, S, R);
}

// the GEMM of a call, then the split reduction where it splits
template <int MODE, typename OutT>
int gemm_and_reduce(const void* a, const void* b, const float* rs,
                    const float* cs, void* out, void* ws, int R, int C,
                    int Kc, int lda, int ldb, int splits, cudaStream_t st,
                    int experts) {
  int e = launch_gemm<MODE, OutT>(a, b, rs, cs, out, ws, R, C, Kc, lda, ldb,
                                  splits, st, experts);
  if (e || splits == 1) return e;
  return launch_reduce<MODE, OutT>(ws, rs, cs, out, R, C, splits, st,
                                   experts);
}

template <int MODE>
int gemm_out(int out_dtype, const void* a, const void* b, const float* rs,
             const float* cs, void* out, void* ws, int R, int C, int Kc,
             int lda, int ldb, int splits, cudaStream_t st,
             int experts = 1) {
  if (out_dtype == kFloat32)
    return gemm_and_reduce<MODE, float>(a, b, rs, cs, out, ws, R, C, Kc, lda,
                                        ldb, splits, st, experts);
  if (out_dtype == kBFloat16)
    return gemm_and_reduce<MODE, __nv_bfloat16>(a, b, rs, cs, out, ws, R, C,
                                                Kc, lda, ldb, splits, st,
                                                experts);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the split reduction alone, by output dtype
template <int MODE>
int reduce_out(int out_dtype, const void* ws, const float* rs,
               const float* cs, void* out, int R, int C, int S,
               cudaStream_t st) {
  if (out_dtype == kFloat32)
    return launch_reduce<MODE, float>(ws, rs, cs, out, R, C, S, st);
  if (out_dtype == kBFloat16)
    return launch_reduce<MODE, __nv_bfloat16>(ws, rs, cs, out, R, C, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
