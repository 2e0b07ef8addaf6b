// Device code shared by the two ConvNeXt stage kernels
// (convnext_stage_fwd.cu, convnext_stage_bwd.cu): the depthwise convolution
// with LayerNorm of one row, GELU(tanh) and its derivative, and the
// workspace carver.  Both kernels run their products on the tensor cores
// (convnext_gemm.cuh).
//
// A stage is a chain of blocks over rows (B * L, C): depthwise conv k=7 SAME
// -> LayerNorm (fp32, eps 1e-5) -> 1x1 to H -> GELU(tanh) -> 1x1 back ->
// layer scale gamma -> + residual.  The TPU kernels keep a whole sample and
// every weight of the stage in fast memory and walk the blocks inside one
// grid cell.  Here a block of the stage is a short sequence of launches
// inside one C entry: the convolution's halo grows by 3 rows per block, so
// a row tile cannot run the stage alone, and the kernel boundary is the
// grid-wide barrier between blocks.  What passes from launch to launch is
// a scratch of one block's rows, reused for every block.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace a2m {
namespace cnx {

constexpr int kTaps = 7;           // depthwise kernel size, SAME padding 3 + 3
constexpr float kLnEps = 1e-5f;
constexpr float kGeluC0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluC1 = 0.044715f;
constexpr int kRowThreads = 256;   // row kernels: 8 warps, one row per warp at a time
constexpr int kRowWarps = kRowThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the butterfly leaves the same bits in every lane
}

// tanh(sqrt(2/pi) (a + 0.044715 a^3)): the inner term of GELU(tanh).
__device__ __forceinline__ float gelu_tanh_term(float a) {
  return tanhf(kGeluC0 * (a + kGeluC1 * a * a * a));
}

__device__ __forceinline__ float gelu_from_tanh(float a, float th) {
  return 0.5f * a * (1.0f + th);
}

// d/da of 0.5 a (1 + tanh(u(a))).
__device__ __forceinline__ float gelu_grad_from_tanh(float a, float th) {
  const float sech2 = 1.0f - th * th;
  return 0.5f * (1.0f + th) + 0.5f * a * sech2 * kGeluC0 * (1.0f + 3.0f * kGeluC1 * a * a);
}

// One row of the block's first half, by one warp: the depthwise convolution
// of row `r` (position `pos` of its sample; taps outside [0, L) of that
// sample are zero) plus bias, then the LayerNorm statistics.  Leaves the
// normalized row (u - mean) * rstd in buf[0..C) -- each lane its own columns
// -- and returns rstd.  ROUND_U rounds the convolution's output to the
// storage type before the statistics, as the backward kernel's recompute
// does; the forward kernel keeps it in fp32, and hands in x as the tile of
// rows it staged in shared memory.  The taps add in order with separate
// multiplies and adds, as the plain version does.
template <typename T, bool ROUND_U>
__device__ __forceinline__ float conv_ln_row(const T* __restrict__ x, const T* __restrict__ dw,
                                             const T* __restrict__ dwb, long long r, int pos,
                                             int L, int C, float* buf, int lane) {
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) {
    float u = 0.f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int off = j - kTaps / 2;
      if (pos + off >= 0 && pos + off < L)
        u = __fadd_rn(u, __fmul_rn(to_float(x[(r + off) * C + c]), to_float(dw[j * C + c])));
    }
    u = __fadd_rn(u, to_float(dwb[c]));
    if (ROUND_U) u = round_to<T>(u);
    buf[c] = u;
    sum += u;
  }
  const float mean = warp_sum(sum) / static_cast<float>(C);
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float cent = buf[c] - mean;
    buf[c] = cent;
    sq += cent * cent;
  }
  const float var = warp_sum(sq) / static_cast<float>(C);
  const float rstd = 1.0f / sqrtf(var + kLnEps);
  for (int c = lane; c < C; c += 32) buf[c] *= rstd;
  return rstd;
}

// t = LayerNorm(conv(x)) * scale + bias in the storage type, rows (R, C).
// ln: (2, C) fp32, scale then bias.  Dynamic shared memory: kRowWarps * C
// floats.
template <typename T, bool ROUND_U>
__global__ void __launch_bounds__(kRowThreads)
conv_ln_kernel(const T* __restrict__ x, const T* __restrict__ dw, const T* __restrict__ dwb,
               const float* __restrict__ ln, T* __restrict__ t_out, int R, int L, int C) {
  extern __shared__ float smem_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  if (r >= R) return;
  float* buf = smem_rows + warp * C;
  conv_ln_row<T, ROUND_U>(x, dw, dwb, r, static_cast<int>(r % L), L, C, buf, lane);
  for (int c = lane; c < C; c += 32)
    t_out[r * C + c] = from_float<T>(__fadd_rn(__fmul_rn(buf[c], ln[c]), ln[C + c]));
}

template <typename T, bool ROUND_U>
cudaError_t launch_conv_ln(const T* x, const T* dw, const T* dwb, const float* ln, T* t_out,
                           int R, int L, int C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRowWarps) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_ln_kernel<T, ROUND_U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv_ln_kernel<T, ROUND_U><<<(R + kRowWarps - 1) / kRowWarps, kRowThreads, smem, stream>>>(
      x, dw, dwb, ln, t_out, R, L, C);
  return cudaGetLastError();
}

// Carves 256-byte aligned pieces out of one workspace; with a null base it
// only counts, which is how the entries report the size they need.
struct Carver {
  char* base;
  size_t used = 0;
  explicit Carver(void* p) : base(static_cast<char*>(p)) {}
  template <typename U>
  U* take(size_t count) {
    U* p = base == nullptr ? nullptr : reinterpret_cast<U*>(base + used);
    used += (count * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

constexpr size_t kMaxSharedBytes = 232448;  // what one block may use on sm_90

}  // namespace cnx
}  // namespace a2m
