// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes from
// xdiffusion_tpu_torch/ops/_build.py). Activations are stored as fp32 or
// bf16 (`dtype` argument: XD_F32 / XD_BF16); all arithmetic runs in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define XD_EXPORT extern "C" __attribute__((visibility("default")))

enum { XD_F32 = 0, XD_BF16 = 1 };

// Error codes returned next to cudaError_t values (which are < 1000).
enum { XD_ERR_DTYPE = 1001, XD_ERR_SHAPE = 1002 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// v rounded to the storage type T and widened back (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }
