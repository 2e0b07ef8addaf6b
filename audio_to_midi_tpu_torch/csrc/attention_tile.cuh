// A scalar online-softmax tile loop, without a dropout mask.  It serves only
// kernel 10 (rope_attention.cu), whose rows enter through a RoPE prologue,
// until that kernel moves onto the tensor-core body (global_attention_fwd.cuh)
// as kernels 1, 3, 4 and 15 have.
//
// A block of 256 threads takes a 64-row query tile of one (sample, head)
// and streams 64-column key tiles through shared memory; 4 threads own one
// query row (the row max and sum reduce in two shuffles), each with hd / 4
// output accumulators in registers; nothing of size S x S is stored.  The
// element source `Src` says where the rows come from and what happens to an
// element as it enters shared memory:
//   float q(int row, int d)  -- q scaled by 1/sqrt(hd) in its dtype
//   float k(int col, int d), float v(int col, int d)
//   void store(int row, int d, float x)  -- x rounded to the output dtype
// The masks are kernel 1's with every column below S valid: columns >= S
// never count, and with block > 0 a column outside the row's block of
// `block` rows is -1e30, so a row whose block is all masked (none here:
// the row's own column is in it) would average the S columns.

#pragma once

#include <math.h>

#include "common.cuh"

namespace a2m {
namespace tile {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kMaskFill = -1e30f;

// Q and K tiles padded by one column against bank conflicts, the V tile, and
// the probabilities of the current key tile.
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kTileQ * (HD + 1) + kTileK * (HD + 1) + kTileK * HD + kTileQ * (kTileK + 1));
}

// The attention of query tile q0 over all S columns; `smem` holds
// smem_bytes<HD>() bytes.  Called by all kThreads threads of the block.
template <int HD, class Src>
__device__ __forceinline__ void attend(const Src& src, int q0, int S, int block,
                                       float* __restrict__ smem) {
  float* sQ = smem;
  float* sK = sQ + kTileQ * (HD + 1);
  float* sV = sK + kTileK * (HD + 1);
  float* sP = sV + kTileK * HD;
  const int tid = threadIdx.x;

  for (int i = tid; i < kTileQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    sQ[r * (HD + 1) + d] = q0 + r < S ? src.q(q0 + r, d) : 0.f;
  }

  const int r = tid >> 2;    // query row within the tile
  const int part = tid & 3;  // this thread's share of the row
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
      const bool inside = k0 + c < S;
      sK[c * (HD + 1) + d] = inside ? src.k(k0 + c, d) : 0.f;
      sV[c * HD + d] = inside ? src.v(k0 + c, d) : 0.f;
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
      const bool keep = block <= 0 || row / block == col / block;
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
      tile_sum += p;
      sP[r * (kTileK + 1) + part + 4 * j] = p;
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
    for (int i = 0; i < kDims; ++i) src.store(row, part + 4 * i, acc[i] * inv);
  }
}

}  // namespace tile
}  // namespace a2m
