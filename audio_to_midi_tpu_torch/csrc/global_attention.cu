// Global attention (optionally block-diagonal) over the natural
// (G, S, H*hd) layout, with an online softmax over key tiles.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_attention_nhd
// (:140, kernel _attention_kernel_nhd -> _nhd_core, :74-137).  Per head:
// logits = (q * 1/sqrt(hd), scaled in q's dtype) . k^T in fp32; columns at
// or past valid_len, and outside the row's block when block > 0, are filled
// with -1e30; fp32 softmax; weights . v accumulated in fp32.
//
// What bounds it on the card: at the serving shapes (G=B windows, S=250,
// 4 heads x 64) one head of one sample is 250 x 250 logits, ~16 MFLOP for
// both products, and its q, k, v, out are 4 x 64 KB (f32).  The whole call
// moves ~4 x B x 256 KB and does ~B x 64 MFLOP, far below both roofs: it is
// bound by latency, by the shared-memory reads of its scalar FMA loops, and
// by how many blocks keep the SMs busy.  Design:
//   * one block per (64-query tile, head, sample): 4 x 4 x B blocks at the
//     serving shapes, so B = 16 already gives 256 blocks for 132 SMs;
//   * q, k and v are read straight from the (G, S, H*hd) strides -- no
//     transposes and no padding of S in the wrapper; the ragged key edge
//     (columns >= S) is excluded inside the kernel;
//   * key tiles of 64 stream through shared memory with an online softmax,
//     so nothing of size S x S is ever stored;
//   * 4 threads own one query row: the row max and sum reduce with two
//     shuffles, and each thread keeps hd/4 output accumulators in registers.
// Masking keeps the TPU kernel's semantics exactly: a masked logit is the
// finite -1e30 (not -inf), so a row whose every column is masked softmaxes
// uniformly over all S columns, while columns past S never count.  With
// the running max starting at -inf, an all-masked tile yields max -1e30 and
// weight 1 per masked column; the first unmasked tile then rescales them by
// exp(-1e30 - m) = 0.
//
// Scalar fp32 FMAs, no tensor cores: a later PR can move the two products
// to wgmma once the path is measured.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kThreads = 256;      // 4 threads per query row
constexpr float kMaskFill = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles padded by one column against bank conflicts, V tile, and
  // the probabilities of the current key tile.
  return sizeof(float) *
         (kTileQ * (HD + 1) + kTileK * (HD + 1) + kTileK * HD + kTileQ * (kTileK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
global_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int S, int H,
                        int valid_len, int block, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileQ * (HD + 1);
  float* sV = sK + kTileK * (HD + 1);
  float* sP = sV + kTileK * HD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;

  for (int i = tid; i < kTileQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = q0 + r;
    sQ[r * (HD + 1) + d] =
        row < S ? a2m::scaled_in_dtype(q[base + row * row_stride + d], scale) : 0.f;
  }

  const int r = tid >> 2;     // query row within the tile
  const int part = tid & 3;   // this thread's share of the row
  const int row = q0 + r;
  constexpr int kDims = HD / 4;
  constexpr int kCols = kTileK / 4;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kTileK) {
    __syncthreads();  // the Q tile is in place; the previous tile's reads are done
    for (int i = tid; i < kTileK * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i % HD;
      const int col = k0 + c;
      const bool inside = col < S;
      const long long off = base + col * row_stride + d;
      sK[c * (HD + 1) + d] = inside ? a2m::to_float(k[off]) : 0.f;
      sV[c * HD + d] = inside ? a2m::to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = part + 4 * j;
      const int col = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(sQ[r * (HD + 1) + d], sK[c * (HD + 1) + d], dot);
      const bool keep = col < valid_len && (block <= 0 || row / block == col / block);
      s[j] = col >= S ? -INFINITY : (keep ? dot : kMaskFill);
      tile_max = fmaxf(tile_max, s[j]);
    }
    // The 4 threads of a row are adjacent lanes of one warp.
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);  // finite: column k0 < S is in every tile
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_new);
      sP[r * (kTileK + 1) + part + 4 * j] = p;
      tile_sum += p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l = l * alpha + tile_sum;
    m = m_new;
    __syncwarp();  // a row's probabilities are written and read by its own 4 lanes

#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    for (int c = 0; c < kTileK; ++c) {
      const float p = sP[r * (kTileK + 1) + c];
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(p, sV[c * HD + part + 4 * i], acc[i]);
    }
  }

  if (row < S) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      out[base + row * row_stride + part + 4 * i] = a2m::from_float<T>(acc[i] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int G, int S,
                   int H, int valid_len, int block, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, G);
  global_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, valid_len, block, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int G,
                        int S, int H, int hd, int valid_len, int block, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, G, S, H, valid_len, block, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, G, S, H, valid_len, block, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, G, S, H, valid_len, block, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (G, S, H*hd) device buffers of one dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int a2m_global_attention(const void* q, const void* k, const void* v, void* out,
                                    int G, int S, int H, int hd, int valid_len, int block,
                                    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case a2m::kFloat32:
      return dispatch_hd<float>(q, k, v, out, G, S, H, hd, valid_len, block, scale, st);
    case a2m::kBFloat16:
      return dispatch_hd<__nv_bfloat16>(q, k, v, out, G, S, H, hd, valid_len, block, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* a2m_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
