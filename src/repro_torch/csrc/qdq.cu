// Fused fake quantization (quantize -> dequantize in one pass) for Hopper
// (sm_90a): the gradient quantizer of every fake_quant recipe with a G spec.
//
// Replaces: src/repro/kernels/qdq.py:qdq_row (its body is _qdq_row_kernel)
// and :qdq_scaled (_qdq_scaled_kernel):
//
//   qdq_row     s[r] = max(max_c |x[r,c]|, 1e-12) / qmax            (per row)
//               y[r,c] = clip(rint(x[r,c] / s[r]), -qmax-1, qmax) * s[r]
//   qdq_scaled  y[r,c] = clip(rint(x[r,c] / s[c or 0]), -qmax-1, qmax) * s[..]
//
// with the scale of qdq_scaled streamed in as (1, F) (per channel) or
// (1, 1) (per tensor), computed outside because its reduction spans rows.
// x and y are (rows, F) in the carrier (float32 or bfloat16); the math is
// float32 with every op rounded on its own: __fdiv_rn (nvcc never turns it
// into a reciprocal multiply), rintf (half to even), __fmul_rn, then one
// round to the carrier -- bit for bit the plain version and the JAX
// reference (kernels/ref.py:qdq_row_ref, qdq_scaled_ref).  NaN propagates
// as in jnp.max / jnp.clip: a NaN in a row makes its scale NaN, and the
// clamp keeps it (max.NaN / min.NaN; fminf/fmaxf would drop a NaN).
//
// Bound: bytes.  One read of x and one write of y (4 bytes an element at
// bfloat16, 8 at float32) against about 6 flops an element: at the train
// path's (8192, 768) and (8192, 3072) gradients that is 25 MB / 101 MB a
// launch at bfloat16, 7.5 / 30 us at 3.35 TB/s.
//
// Design.  qdq_row reads each row from device memory once, by its width
// (16-byte aligned rows whose byte length is a multiple of 16):
// * up to 2 KB (the train path's 768-wide bf16 gradients, 60 of a
//   fake-quant step's 72 launches): a warp a row, 8 rows to a block, the
//   row held in registers (at most 4 packs of 16 bytes a lane) between
//   its absmax and its quantization;
// * up to 24 KB: streaming.  Persistent blocks, as many as fit on an SM,
//   each walking tiles of whole rows round robin.  A producer warp keeps
//   a ring of two stages in shared memory filled by 1-D bulk copies
//   (cp.async.bulk, one copy a tile of R contiguous rows, completed on the
//   stage's mbarrier) while eight consumer warps take the landed tile,
//   8 / R warps a row (R = 8, 4, 2 or 1 rows a tile of at most 24 KB):
//   each reduces its share of the row's absmax from shared memory (16
//   bytes a lane), the warps of a wide row combine theirs through shared
//   memory behind a named barrier, and each then quantizes its share from
//   shared memory and stores 16 bytes a lane.  At the 768-wide bf16 rows
//   it measured slower than the register kernel (H100, queued, L2 cold):
//   a 12 KB tile lands whole before its warps start;
// * wider: the two-pass warp kernel (qdq_row_kernel with 16-byte packs),
//   the second pass re-reading the row from L1.
// Rows whose byte length is not a multiple of 16, or unaligned pointers,
// take qdq_row_kernel with one element a lane.  qdq_scaled (one pass) is
// a warp a row, 8 rows to a block of 256 threads, reading the column's
// scale (or the one scale) from L1.  The TPU kernel's (block_rows, F) VMEM
// tile becomes a warp's strided walk; nothing is padded to 128 lanes.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// clip(rint(x / s), -qmax - 1, qmax) * s, each op rounded on its own
__device__ __forceinline__ float qdq1(float x, float s, float qmax) {
  float r = rintf(__fdiv_rn(x, s));
  const float lo = -qmax - 1.0f;
  r = min_nan(max_nan(r, lo), qmax);  // keeps NaN, as jnp.clip does
  return __fmul_rn(r, s);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
qdq_row_kernel(const T* __restrict__ x, T* __restrict__ y, int rows, int F,
               float qmax) {
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const int nv = F / VEC;
  const P* xr = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * F);
  P* yr = reinterpret_cast<P*>(y + static_cast<size_t>(row) * F);

  float m = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    const P p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = max_nan(m, fabsf(to_f32(p.v[j])));
  }
  m = warp_max_nan(m);
  const float s = __fdiv_rn(max_nan(m, 1e-12f), qmax);

  for (int i = lane; i < nv; i += 32) {
    const P p = xr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f32<T>(qdq1(to_f32(p.v[j]), s, qmax));
    yr[i] = o;
  }
}

constexpr int kRegPacks = 4;                      // 16-byte packs a lane
constexpr int kRegRowMax = 32 * 16 * kRegPacks;  // 2 KB

// rows of at most 2 KB (kRegRowMax): a warp a row, held in registers (up
// to 4 packs of 16 bytes a lane), so it is read once
template <typename T>
__global__ void __launch_bounds__(kThreads)
qdq_row_reg_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                   int F, float qmax) {
  using P = Pack<T, 16 / sizeof(T)>;
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const int nv = F / VEC;
  const P* xr = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * F);
  P* yr = reinterpret_cast<P*>(y + static_cast<size_t>(row) * F);
  P v[kRegPacks];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kRegPacks; ++k) {
    if (lane + 32 * k < nv) {
      v[k] = xr[lane + 32 * k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = max_nan(m, fabsf(to_f32(v[k].v[j])));
    }
  }
  m = warp_max_nan(m);
  const float s = __fdiv_rn(max_nan(m, 1e-12f), qmax);
#pragma unroll
  for (int k = 0; k < kRegPacks; ++k) {
    if (lane + 32 * k < nv) {
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f32<T>(qdq1(to_f32(v[k].v[j]), s, qmax));
      yr[lane + 32 * k] = o;
    }
  }
}

// ---------------------------------------------------------- streaming
constexpr int kStreamWarps = 8;                      // consumer warps
constexpr int kStreamThreads = 32 * (kStreamWarps + 1);  // + the producer
constexpr int kStreamStages = 2;
constexpr int kStageMax = 24 * 1024;  // bytes of a tile: rows up to this
constexpr int kStreamBar = 128;       // the mbarriers, before the stages

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// rows [t * R, t * R + R) of tile t land in one stage; warp w works on row
// w / (8 / R) of it, its share the 16-byte packs w % (8 / R) + k * (8 / R)
// * 32 + lane
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
qdq_row_stream_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                      int F, int R, float qmax) {
  using P = Pack<T, 16 / sizeof(T)>;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][kStreamWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kStreamStages;
  unsigned char* stages = smem + kStreamBar;
  const int row_bytes = F * static_cast<int>(sizeof(T));
  const int stage_bytes = R * row_bytes;
  const int ntiles = (rows + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStreamStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kStreamWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == kStreamWarps) {  // the producer
    if (lane == 0) {
      for (int k = 0, t = blockIdx.x; t < ntiles; ++k, t += gridDim.x) {
        const int st = k % kStreamStages;
        if (k >= kStreamStages)
          mbar_wait(empty0 + 8 * st, ((k / kStreamStages) - 1) & 1);
        const int nr = min(R, rows - t * R);
        mbar_expect_tx(full0 + 8 * st, nr * row_bytes);
        bulk_load(smem_u32(stages + st * stage_bytes),
                  x + static_cast<size_t>(t) * R * F, nr * row_bytes,
                  full0 + 8 * st);
      }
    }
    return;
  }
  const int wpr = kStreamWarps / R;  // warps a row
  const int r_local = warp / wpr, share = warp % wpr;
  const int nv = F / VEC;
  for (int k = 0, t = blockIdx.x; t < ntiles; ++k, t += gridDim.x) {
    const int st = k % kStreamStages;
    const int row = t * R + r_local;
    mbar_wait(full0 + 8 * st, (k / kStreamStages) & 1);
    if (row < rows) {  // uniform over the warps of a row
      const P* xr = reinterpret_cast<const P*>(stages + st * stage_bytes +
                                               r_local * row_bytes);
      float m = 0.0f;
      for (int i = share * 32 + lane; i < nv; i += wpr * 32) {
        const P p = xr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) m = max_nan(m, fabsf(to_f32(p.v[j])));
      }
      m = warp_max_nan(m);
      if (wpr > 1) {
        // double-buffered by tile parity: a warp rewrites its slot only
        // after the next tile's barrier, which its row's warps reach only
        // once they have read this tile's slots
        if (lane == 0) red[k & 1][warp] = m;
        named_sync(1 + r_local, wpr * 32);
        for (int w = 0; w < wpr; ++w)
          m = max_nan(m, red[k & 1][r_local * wpr + w]);
      }
      const float s = __fdiv_rn(max_nan(m, 1e-12f), qmax);
      P* yr = reinterpret_cast<P*>(y + static_cast<size_t>(row) * F);
      for (int i = share * 32 + lane; i < nv; i += wpr * 32) {
        const P p = xr[i];
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f32<T>(qdq1(to_f32(p.v[j]), s, qmax));
        yr[i] = o;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
qdq_scaled_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  T* __restrict__ y, int rows, int F, int per_channel,
                  float qmax) {
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const int nv = F / VEC;
  const P* xr = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * F);
  P* yr = reinterpret_cast<P*>(y + static_cast<size_t>(row) * F);
  const float s0 = scale[0];
  for (int i = lane; i < nv; i += 32) {
    const P p = xr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = per_channel ? scale[i * VEC + j] : s0;
      o.v[j] = from_f32<T>(qdq1(to_f32(p.v[j]), s, qmax));
    }
    yr[i] = o;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte packs where F and both pointers allow, else one element a lane
template <typename T>
bool packed(const void* x, const void* y, int F) {
  return F % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(y);
}

// one warp per row
dim3 row_grid(int rows) {
  return dim3((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// rows a tile of the streaming kernel: 8, 4, 2 or 1 (the most that fit
// in kStageMax), or 0 where a row does not fit
int stream_rows(int row_bytes) {
  for (int r = 8; r >= 1; r /= 2)
    if (r * row_bytes <= kStageMax) return r;
  return 0;
}

template <typename T>
cudaError_t launch_row(const void* x, void* y, int rows, int F, float qmax,
                       cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int R = stream_rows(F * static_cast<int>(sizeof(T)));
  if (!packed<T>(x, y, F)) {
    qdq_row_kernel<T, 1><<<row_grid(rows), kThreads, 0, s>>>(xt, yt, rows,
                                                             F, qmax);
  } else if (F * static_cast<int>(sizeof(T)) <= kRegRowMax) {
    qdq_row_reg_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(xt, yt, rows,
                                                             F, qmax);
  } else if (R == 0) {  // a row wider than a stage: two passes
    qdq_row_kernel<T, V><<<row_grid(rows), kThreads, 0, s>>>(xt, yt, rows,
                                                             F, qmax);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        qdq_row_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStreamBar + kStreamStages * kStageMax);
    if (attr != cudaSuccess) return attr;
    const int tiles = (rows + R - 1) / R;
    const int smem = kStreamBar + kStreamStages * R * F *
                                      static_cast<int>(sizeof(T));
    int per_sm = 0;  // as many blocks as fit on an SM, each on its tiles
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qdq_row_stream_kernel<T>, kStreamThreads, smem);
    if (occ != cudaSuccess) return occ;
    const int grid = min(tiles, max(per_sm, 1) * sm_count());
    qdq_row_stream_kernel<T><<<grid, kStreamThreads, smem, s>>>(
        xt, yt, rows, F, R, qmax);
  }
  return cudaGetLastError();
}

template <typename T>
void launch_scaled(const void* x, const float* scale, void* y, int rows,
                   int F, int per_channel, float qmax, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (packed<T>(x, y, F))
    qdq_scaled_kernel<T, V><<<row_grid(rows), kThreads, 0, s>>>(
        xt, scale, yt, rows, F, per_channel, qmax);
  else
    qdq_scaled_kernel<T, 1><<<row_grid(rows), kThreads, 0, s>>>(
        xt, scale, yt, rows, F, per_channel, qmax);
}

}  // namespace

// x, y (rows, F) contiguous in dtype (0 float32, 1 bfloat16); rows, F >= 1.
extern "C" int repro_qdq_row(const void* x, void* y, int rows, int F,
                             int bits, int dtype, void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return static_cast<int>(launch_row<float>(x, y, rows, F, qmax, s));
  if (dtype == kBFloat16)
    return static_cast<int>(
        launch_row<__nv_bfloat16>(x, y, rows, F, qmax, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y as above; scale float32, F values (per_channel 1) or one (0).
extern "C" int repro_qdq_scaled(const void* x, const void* scale, void* y,
                                int rows, int F, int per_channel, int bits,
                                int dtype, void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float* sc = static_cast<const float*>(scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_scaled<float>(x, sc, y, rows, F, per_channel, qmax, s);
  else if (dtype == kBFloat16)
    launch_scaled<__nv_bfloat16>(x, sc, y, rows, F, per_channel, qmax, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
