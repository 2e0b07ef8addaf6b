// Device code shared by the two ConvNeXt stage kernels
// (convnext_stage_fwd.cu, convnext_stage_bwd.cu): the depthwise convolution
// with LayerNorm of one row, GELU(tanh) and its derivative, and the tiled
// matrix product on the CUDA cores of the stage forward, with a functor for
// its epilogue.
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
//
// gemm_kernel, the product on the CUDA cores, serves the stage forward
// (kernel 19) alone: the products of the stage backward (kernel 20) and of
// the fused transformer layers (kernels 11, 17, 18) run on the tensor cores
// (convnext_gemm.cuh).  It runs 64 x 64 x 16 tiles in shared memory, 256
// threads with 4 x 4 accumulators each, fp32 FMAs on operands widened from
// the storage type: both storage types (f32, bf16) take the same code and
// the same summation order, which is fixed, so a call repeats bit for bit.
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

constexpr int kBM = 64, kBN = 64, kBK = 16, kPad = 4;
constexpr int kGemmThreads = 256;
static_assert(kBM == kBN && kBM * kBK == 4 * kGemmThreads, "load_tile: 4 elements a thread");

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
// does; the forward kernel keeps it in fp32.  The taps add in order with
// separate multiplies and adds, as the plain version does.
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

// A (64 x 16) operand tile into shared memory as dst[k][i], widened to fp32
// and zero outside [0, ilim) x [0, klim).  K_CONTIG: element (i, k) lies at
// src[i * ld + k] (a row-major operand read along its rows); otherwise at
// src[k * ld + i] (read down its columns, neighbouring threads on
// neighbouring addresses).
template <typename T, bool K_CONTIG>
__device__ __forceinline__ void load_tile(float (*dst)[kBM + kPad], const T* __restrict__ src,
                                          int ld, int i0, int ilim, int k0, int klim, int tid) {
  if (K_CONTIG) {
    const int i = tid >> 2, kq = (tid & 3) * 4;
    const int gi = i0 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + kq + q;
      float v = 0.f;
      if (gi < ilim && gk < klim) v = to_float(src[static_cast<size_t>(gi) * ld + gk]);
      dst[kq + q][i] = v;
    }
  } else {
    const int k = tid >> 4, iq = (tid & 15) * 4;
    const int gk = k0 + k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gi = i0 + iq + q;
      float v = 0.f;
      if (gi < ilim && gk < klim) v = to_float(src[static_cast<size_t>(gk) * ld + gi]);
      dst[k][iq + q] = v;
    }
  }
}

// out(m, n) = sum_k A(m, k) B(n, k) over k in [z * chunk, (z + 1) * chunk)
// of [0, K), z = blockIdx.z, handed element by element to epi(m, n, sum, z).
// Each operand is read along k (K_CONTIG) or across it, see load_tile.  The
// sum runs in k order in one thread, whatever the grid: the same call gives
// the same bits.
template <typename T, bool A_KC, bool B_KC, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K, int lda,
            int ldb, int chunk, Epi epi) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    load_tile<T, A_KC>(As, A, lda, m0, M, k0, k_end, tid);
    load_tile<T, B_KC>(Bs, B, ldb, n0, N, k0, k_end, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) epi(m, n, acc[i][j], static_cast<int>(blockIdx.z));
    }
  }
}

template <typename T, bool A_KC, bool B_KC, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, int M, int N, int K, int lda, int ldb, int chunk,
                        int splits, const Epi& epi, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  gemm_kernel<T, A_KC, B_KC, Epi><<<grid, kGemmThreads, 0, stream>>>(A, B, M, N, K, lda, ldb,
                                                                      chunk, epi);
  return cudaGetLastError();
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
