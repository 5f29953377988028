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
// clamp is written with comparisons (fminf/fmaxf would drop a NaN).
//
// Bound: bytes.  One read of x and one write of y (4 bytes an element at
// bfloat16, 8 at float32) against about 6 flops an element: at the train
// path's (8192, 768) and (8192, 3072) gradients that is 25 MB / 101 MB a
// launch at bfloat16, 7.5 / 30 us at 3.35 TB/s.
//
// Design, the simple version first: one warp per row (8 rows to a block of
// 256 threads) for both.  qdq_row makes two passes over its row -- the
// absmax, a warp shuffle reduction, then quantize and write; the second
// pass re-reads the row, which the warp has just read, from L1/L2.
// qdq_scaled makes the second pass only, reading the column's scale (or
// the one scale) from L1.  The TPU kernel's (block_rows, F) VMEM tile
// becomes a warp's strided walk; nothing is padded to 128 lanes.  Loads
// and stores move 16 bytes a lane (8 bfloat16 or 4 float32 values) where
// F and the pointers allow it, else one element.
#include "common.cuh"

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
  r = r < lo ? lo : (r > qmax ? qmax : r);  // keeps NaN, as jnp.clip does
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

template <typename T>
void launch_row(const void* x, void* y, int rows, int F, float qmax,
                cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (packed<T>(x, y, F))
    qdq_row_kernel<T, V><<<row_grid(rows), kThreads, 0, s>>>(xt, yt, rows,
                                                             F, qmax);
  else
    qdq_row_kernel<T, 1><<<row_grid(rows), kThreads, 0, s>>>(xt, yt, rows,
                                                             F, qmax);
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
    launch_row<float>(x, y, rows, F, qmax, s);
  else if (dtype == kBFloat16)
    launch_row<__nv_bfloat16>(x, y, rows, F, qmax, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
