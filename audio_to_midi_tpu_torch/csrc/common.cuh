// Shared helpers for the attention kernels: dtype conversion, the in-dtype
// query scaling that the TPU kernels apply, and the halves-layout RoPE.
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

// x rounded to T and widened again: where the TPU kernels cast an fp32
// intermediate to the working dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Element d of the RoPE'd head vector `head` (hd values, halves layout) at
// the table row (cos, sin: hd / 2 values), rounded to T.  The products and
// the difference round separately, as in the plain versions.
template <typename T>
__device__ __forceinline__ float rope_elem(const T* __restrict__ head, int d, int hd,
                                           const float* __restrict__ cos_row,
                                           const float* __restrict__ sin_row) {
  const int half = hd / 2;
  const int f = d < half ? d : d - half;
  const float x1 = to_float(head[f]);
  const float x2 = to_float(head[f + half]);
  const float c = cos_row[f], s = sin_row[f];
  const float y = d < half ? __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))
                           : __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
  return round_to<T>(y);
}

}  // namespace a2m
