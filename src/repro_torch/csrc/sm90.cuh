// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_q8_sm90.cu, gemm_s8.cuh) and
// the streaming ones (opt_update.cu, qdq.cu, decode_attn.cu):
// shared-memory addresses, mbarriers, TMA tile loads, 1-D bulk copies,
// wgmma descriptors, fences and the bf16 wgmma forms, the exact three-term
// bf16 split and the split of a scaled Q tile, and the lookup of
// cuTensorMapEncodeTiled through the runtime (so no library links -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;  // a block's dynamic shared memory, sm_90
// registers a producer warpgroup keeps after setmaxnreg.dec
constexpr int kProducerRegs = 24;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// make the barrier inits visible to the async proxy (TMA) before first use
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------------ TMA
// one box of a 2-D tensor map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 3-D map
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// the same for a 4-D map
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, completing `bar`'s transaction
// bytes: no tensor map (opt_update.cu, qdq.cu)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// a shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4).  A K-major operand in
// 128-byte rows (64 bf16 or 128 int8 values) takes lbo 16 and sbo 1024
// (eight rows); its k-steps of 32 bytes advance the start address.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register traffic across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// sc = t (first) or sc + t, in fp32 round-to-nearest (the tensor cores'
// own fp32 sums do not round to nearest)
template <int N>
__device__ __forceinline__ void add_tile(float (&sc)[N], float (&t)[N],
                                         bool first) {
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < N; ++i) sc[i] = first ? t[i] : __fadd_rn(sc[i], t[i]);
}

// the bf16 forms, fp32 accumulators: m64 x nN is N / 2 registers a thread,
// element 4j + 2i + e at row 16 * warp + lane / 4 + 8i, column 8j +
// 2 * (lane % 4) + e
#define SM90_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d (m64 x n32, fp32) (+)= A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_F8(0), SM90_F8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 x n64, fp32) (+)= A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// S (m64 x nN) (+)= A . B, both K-major in shared memory, N = 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_ss: N is 32 or 64");
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n32(d, a, b, accumulate);
}

// d (m64 x n64, fp32) (+)= A (registers, bf16 pairs) . B (smem, MN-major).
// A's k16 slice kk of an m64 x nN accumulator fragment x is the registers
// pack_bf16(x[8kk + 2r], x[8kk + 2r + 1]), r = 0..3.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}
#undef SM90_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x as three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
// - mid): hi + mid + lo == x exactly while |x| >= 2^-110 (below, bf16's
// subnormal step of 2^-133 drops at most 2^-134); a non-finite hi leaves
// mid = lo = 0, so an inf or a NaN stays one.  Each product of a term with
// a bf16 value is exact in fp32.  kernels/flash_attn.py:bf16_terms is the
// same formula.
__device__ __forceinline__ void bf16_terms(float x, float& hi, float& mid,
                                           float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = fabsf(hi) <= FLT_MAX ? __fsub_rn(x, hi) : 0.0f;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __fsub_rn(r, mid);  // exact; rounded to bf16 where it is packed
}

// max(l, 1e-30) that keeps a NaN l (jnp.maximum; fmaxf would drop it)
__device__ __forceinline__ float floor_l(float l) {
  return l < 1e-30f ? 1e-30f : l;
}

// The Q tile's 16 bytes at t0 + off (eight bf16 values of q) as the terms
// the tensor cores read (flash_fwd_sm90.cu, flash_q8_sm90.cu): x = fl(q *
// scale) in place as hi (term 0), and for NQ = 3 its remainders
// mid and lo (terms 1, 2, bf16_terms): hi + mid + lo == x exactly
// while |x| >= 2^-110, hi == x at a power-of-two scale while |x| >= 2^-126
// (below, bf16's subnormal step of 2^-133 drops at most 2^-134); a
// non-finite hi leaves mid = lo = 0 so an inf in q stays an inf score.  The
// same formula: kernels/flash_attn.py:bf16_q_terms.
template <int NQ>
__device__ __forceinline__ void split_q(uint8_t* t0, int q_bytes, int off,
                                        float scale) {
  uint4 in = *reinterpret_cast<uint4*>(t0 + off);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&in);
  uint4 hi4, mid4, lo4;
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(&hi4);
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(&mid4);
  __nv_bfloat16* lo = reinterpret_cast<__nv_bfloat16*>(&lo4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // __fmul_rn: x is rounded once, never fused into the subtraction
    const float x = __fmul_rn(__bfloat162float(e[i]), scale);
    if constexpr (NQ == 3) {
      float h, m, l;
      bf16_terms(x, h, m, l);
      hi[i] = __float2bfloat16_rn(h);
      mid[i] = __float2bfloat16_rn(m);
      lo[i] = __float2bfloat16_rn(l);
    } else {
      hi[i] = __float2bfloat16_rn(x);
    }
  }
  *reinterpret_cast<uint4*>(t0 + off) = hi4;
  if constexpr (NQ == 3) {
    *reinterpret_cast<uint4*>(t0 + q_bytes + off) = mid4;
    *reinterpret_cast<uint4*>(t0 + 2 * q_bytes + off) = lo4;
  }
}

// ------------------------------------------- programmatic dependent launch
// wait until the grid this one depends on (the kernel before it on the
// stream) has finished and its writes are visible; returns at once when the
// grid was launched without launch_pdl
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ----------------------------------------------------------------- host
// cuTensorMapEncodeTiled, reached through the runtime so the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// launch `kern` so that the card may start it while the kernel before it on
// the stream drains (programmatic dependent launch): the kernel must call
// grid_dependency_wait() before it reads what that kernel wrote
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kern)(KArgs...), dim3 grid, dim3 block, size_t smem,
               cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kern, static_cast<KArgs>(args)...));
}

// a (BH, S, HD) bf16 tensor as a 3-D TMA map, boxes of 64 columns x rows x
// 1, 128-byte swizzle; the hardware fills zeros past S and past HD
inline bool make_map_bf16_3d(CUtensorMap* map, const void* base, int BH,
                             int S, int HD, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(S) * HD * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count, read once
inline int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  return n_sm;
}

}  // namespace
