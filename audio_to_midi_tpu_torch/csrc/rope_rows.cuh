// The RoPE pass over rows of q and k, shared by the fused layers' global
// core (fused_layer_impl.cuh, TPU kernels 11, 17, 18) and kernel 10
// (rope_attention.cu, fused_rope_attention), whose RoPE'd rows then enter a
// tensor-core attention body.  It rotates each element in fp32 from the
// values cast to fp32 (rope_elem's arithmetic, common.cuh), rounds it to T,
// and with scale != 1 multiplies q by it and rounds to T again.  It moves
// bytes: one read and one write of q and k, 16 bytes a thread, and the two
// fp32 tables' rows.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace a2m {
namespace fl {

constexpr int kRowThreads = 256;

// The values of T in a 16-byte piece, widened to fp32, and back.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&x)[kVec]) {
    x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&x)[kVec]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&x)[kVec]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half of word i
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&x)[kVec]) {
    return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                      pack_bf16(x[6], x[7]));
  }
};

// RoPE in place on the rows of q and k (B P rows of H heads, each 16-byte
// aligned): fp32 on the cast values, table row = the row's position in its
// sample (rope_elem's arithmetic), rounded to T; q then times `scale`,
// rounded to T again (scale 1 leaves the rounded rotation as it is).  One
// thread per pair of 16-byte pieces that the rotation pairs: a head's
// first-half piece f0 and f0 + hd / 2.  The fused layers' local core cannot
// take rows rotated once: its table depends on the window.
template <typename T, int HD>
__global__ void __launch_bounds__(kRowThreads)
rope_rows_kernel(T* __restrict__ q, T* __restrict__ k, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, long long items, int P, int H, float scale) {
  constexpr int kVec = Piece<T>::kVec;
  constexpr int kHalf = HD / 2;
  constexpr int kPieces = kHalf / kVec;  // per half head
  static_assert(kHalf % kVec == 0, "whole 16-byte pieces in a half head");
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= items) return;
  const int f0 = static_cast<int>(i % kPieces) * kVec;
  const long long head_row = i / kPieces;  // row * H + head
  const long long row = head_row / H;
  const float* c = cos_t + static_cast<size_t>(row % P) * kHalf + f0;
  const float* s = sin_t + static_cast<size_t>(row % P) * kHalf + f0;
  const long long at = row * H * HD + (head_row % H) * HD + f0;
#pragma unroll
  for (int which = 0; which < 2; ++which) {  // q, then k
    T* x = (which == 0 ? q : k) + at;
    float x1[kVec], x2[kVec];
    Piece<T>::unpack(*reinterpret_cast<const uint4*>(x), x1);
    Piece<T>::unpack(*reinterpret_cast<const uint4*>(x + kHalf), x2);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float u1 = x1[e], u2 = x2[e];
      x1[e] = round_to<T>(__fsub_rn(__fmul_rn(u1, c[e]), __fmul_rn(u2, s[e])));
      x2[e] = round_to<T>(__fadd_rn(__fmul_rn(u1, s[e]), __fmul_rn(u2, c[e])));
      if (which == 0) {
        x1[e] = scaled_in_dtype(from_float<T>(x1[e]), scale);
        x2[e] = scaled_in_dtype(from_float<T>(x2[e]), scale);
      }
    }
    *reinterpret_cast<uint4*>(x) = Piece<T>::pack(x1);
    *reinterpret_cast<uint4*>(x + kHalf) = Piece<T>::pack(x2);
  }
}

}  // namespace fl
}  // namespace a2m
