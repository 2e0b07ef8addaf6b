// Shared helpers for the attention kernels: dtype conversion and the
// in-dtype query scaling that the TPU kernels apply.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace a2m {

// Element types the kernels take; the codes match the Python wrapper.
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q * scale rounded to the input dtype, then widened: the TPU kernels scale
// q in its own dtype before the fp32-accumulated q.k product.  The product
// of two bf16 values is exact in fp32, so this is bf16 multiplication.
template <typename T>
__device__ __forceinline__ float scaled_in_dtype(T x, float scale) {
  return to_float(from_float<T>(to_float(x) * scale));
}

}  // namespace a2m
