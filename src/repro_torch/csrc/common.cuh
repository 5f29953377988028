// Shared helpers of the port's CUDA kernels.  Each kernel source builds into
// its own shared library with a plain C interface (kernels/_build.py); every
// library exports repro_error_string so the Python wrapper can name an error.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype codes passed by the wrappers for carrier tensors
enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

// 0-scale sidecars (never-written cache rows, zero padding) -> 1.0: the
// payload there is 0, so the product stays 0 and no 0/0 can appear.  The
// counterpart of repro/kernels/int8_matmul.py:scale_guard.
__device__ __forceinline__ float scale_guard(float s) {
  return s == 0.0f ? 1.0f : s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jnp.max / torch.amax semantics: a NaN operand gives NaN (max.NaN and
// min.NaN are one instruction each, as fmaxf and fminf, which drop a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float warp_max_nan(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
