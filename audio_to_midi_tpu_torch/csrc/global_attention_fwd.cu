// Forward of the global (optionally block-diagonal) attention on the tensor
// cores, over the natural (G, S, H*hd) layout.  One body for two TPU kernels
// of audio_to_midi_tpu/ops/pallas_attention.py:
//   * kernel 1, fused_attention_nhd (:140 -> pallas_call :154, body
//     _nhd_core :74-126), reached through a2m_global_attention without a
//     mask source (global_attention.cu);
//   * kernel 3, fused_attention (:219; _fused_attention_impl :170 ->
//     pallas_call :190, body _attention_kernel :36-64), reached through
//     a2m_head_major_attention (head_major_attention.cu): a contiguous
//     head-major (G, H, S, hd) tensor is the natural layout (G*H, S, 1*hd),
//     so kernel 3 is this body on G*H samples of one head with valid_len = S.
//     The TPU kernel's packing of several heads into one cell is its VMEM
//     layout, not its function.
// Per head, with T the working dtype and every product accumulated in fp32:
//   logits = round_T(q * 1/sqrt(hd)) . k^T; a column at or past valid_len,
//   or outside the row's block of `block` rows when block > 0, is the finite
//   -1e30; columns at or past S never count; out = softmax(logits) . v,
//   cast to T.
// The softmax is online over 64-column key tiles: each tile's unnormalised
// weights exp(s - m) are rounded to T for their product with v (bf16: the
// TPU kernels' weights.astype(v.dtype), :121 and :63; f32: no rounding), and
// the output is divided by the fp32 row sum of the unrounded weights at the
// end.  A row whose every column is masked averages all S columns, as on
// the TPU: its logits are -1e30, not -inf.
//
// What bounds it on this card.  At the serving shapes (B windows, S = 250,
// 4 heads x 64) the call reads q, k, v and writes out, 4 x B x 128 KB in
// bf16, and does 4 x B x 4 x 250^2 x 64 = 64 B MFLOP: at B = 128, 65.5 MB
// (19.6 us at 3.35 TB/s) and 8.2 GFLOP (8.3 us at 989 TFLOP/s) -- bf16 is
// bound by its bytes; f32 moves twice the bytes and, as 3xTF32, runs three
// tf32 products per product (50 us at 495 TFLOP/s).  The scalar body it
// replaces ran both products as fp32 FMAs whose operands came from
// shared memory, element by element, with the weights stored there between
// them, so bf16 ran at f32's speed.  What the design does:
//   * both products on the tensor cores (mma.sync, mma_tile.cuh): bf16
//     m16n8k16 fed by ldmatrix, the V tile through ldmatrix.trans; f32 as
//     3xTF32 m16n8k8, each k-step in a fresh accumulator;
//   * one block of 4 warps per (64-query tile, head, sample), 16 query rows
//     per warp: a row's max and sum reduce in its quad of lanes with two
//     shuffles; the row sum is reduced once, at the end;
//   * the Q tile is copied once and scaled in T by the threads that copied
//     it; in bf16 it then stays in registers as A fragments, in f32 it is
//     read from shared memory at each k-step (register-resident hi / lo
//     splits spilled at hd 64 in the backward);
//   * K and V stream in 64-row tiles through two stages of 16-byte
//     cp.async, rows at or past S zero-filled, so the next tile's copy
//     overlaps this tile's two products;
//   * S = Q . K^T of a key tile stays in fp32 accumulators (8 n8 tiles per
//     warp for 64 keys); the masks and the online-softmax rescale are
//     applied there, and the weights are packed from those registers
//     straight into the A fragments of O += P . V: no weight tile in shared
//     memory;
//   * the key tiles walked are those that hold a column some row of the
//     query tile can see: below valid_len and, with block > 0, inside the
//     rows' blocks.  Skipping the others is exact (each adds exp(-1e30 - m)
//     = 0) only where every row of the tile has a column below valid_len,
//     so with a fully masked row in the tile every tile up to S is walked;
//   * no atomics: the same inputs give the same bits.
// A dropout mask source enters where P is formed, as in the backward
// (global_attention_bwd.cuh): the template parameter MASK.  Only kMaskNone
// is instantiated; dropout (TPU kernels 4 and 15) still runs on the scalar
// body of global_attention.cu.

#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "global_attention_fwd.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh)

template <typename T, int HD, int MASK>
constexpr size_t fwd_smem_bytes() {
  // Q and two stages of K, V; with dropout, the mask bytes of a tile.
  return sizeof(T) * 5 * kTile * pitch<T, HD>() +
         (MASK == kMaskNone ? 0 : kMaskTile * kMaskPitch);
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 2)  // blocks to an SM at hd 64
global_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ bits,
                            const int* __restrict__ seed, T* __restrict__ out, int S, int H,
                            int valid_len, int block, int threshold, float scale) {
  static_assert(kTile == kMaskTile, "mask tile is 64 x 64");
  constexpr int kLd = pitch<T, HD>();
  constexpr int kElems = kTile * kLd;
  constexpr int kChunks = kTile / kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kElems;          // stage s at sK + s * kElems
  T* sV = sK + 2 * kElems;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kElems);

  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int q0 = blockIdx.x * kTile;
  const int rows[2] = {q0 + m0 + grp, q0 + m0 + grp + 8};
  const bool live = q0 + m0 < S;           // the warp has a row below S
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const MaskPlane plane = make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
  const int row_block[2] = {block > 0 ? rows[0] / block : 0, block > 0 ? rows[1] / block : 0};

  // The columns [lo, hi) to walk.  Every row of the tile sees a column below
  // valid_len unless, with block > 0, the block of its last row starts at or
  // past valid_len; then all S columns are walked.
  int lo = 0, hi = valid_len;
  if (block > 0) {
    const int last_block = (min(q0 + kTile, S) - 1) / block * block;
    if (last_block < valid_len) {
      lo = q0 / block * block;
      hi = min(valid_len, last_block + block);
    } else {
      hi = S;
    }
  }
  const int first = lo / kTile, last = (hi - 1) / kTile;

  copy_tile<T, HD>(sQ, q, base, row_stride, q0, S);
  copy_tile<T, HD>(sK, k, base, row_stride, first * kTile, S);
  copy_tile<T, HD>(sV, v, base, row_stride, first * kTile, S);
  cp_commit();
  cp_wait<0>();
  scale_own_pieces<T, HD>(sQ, scale);
  __syncthreads();
  const Resident<T, HD> rq(sQ, m0);

  // Row statistics of rows grp and grp + 8: the running max (quad-uniform)
  // and this lane's share of the running sum.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = first; t <= last; ++t) {
    const int stage = (t - first) & 1;
    const int k0 = t * kTile;
    if (t < last) {  // the next tile into the other stage
      copy_tile<T, HD>(sK + (stage ^ 1) * kElems, k, base, row_stride, k0 + kTile, S);
      copy_tile<T, HD>(sV + (stage ^ 1) * kElems, v, base, row_stride, k0 + kTile, S);
    }
    cp_commit();
    fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    cp_wait<1>();
    __syncthreads();

    if (live) {  // warp-uniform: a warp wholly past S has nothing to store
      const T* tK = sK + stage * kElems;
      const T* tV = sV + stage * kElems;
      float s[kChunks][2][4];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) chunk_product<T, HD>(s[c], rq, tK, c * kChunk);
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = k0 + c * kChunk + 8 * j + 2 * quad + (e & 1);
            const bool keep = col < valid_len && (block <= 0 || row_block[r] == col / block);
            s[c][j][e] = col >= S ? -INFINITY : (keep ? s[c][j][e] : kMaskFill);
            tile_max[r] = fmaxf(tile_max[r], s[c][j][e]);
          }
      // Column k0 < S is in every tile, so the new max is finite; a tile
      // whose columns are all masked for a row gives it -1e30, and its
      // weights 1 are wiped by the rescale exp(-1e30 - m) = 0 at the first
      // tile with a visible column.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(tile_max[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // P is formed here: the row sum takes the weights as they are, the
      // product with v takes them through the mask source and rounded to T.
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = expf(s[c][j][e] - m[r]);
            l[r] += p;
            s[c][j][e] = p;
            if (MASK != kMaskNone) {
              const int byte = sMask[(m0 + grp + 8 * r) * kMaskPitch + c * kChunk + 8 * j +
                                     2 * quad + (e & 1)];
              s[c][j][e] = apply_mask_byte(p, byte, threshold, keep_inv);
            }
          }
        accumulate_product<T, HD>(acc, s[c], tV, c * kChunk);
      }
    }
    __syncthreads();  // this stage and the mask tile are read; both may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);
    if (rows[r] >= S) continue;
    T* dst = out + base + rows[r] * row_stride + 2 * quad;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair<T>(dst + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <typename T, int HD, int MASK>
cudaError_t launch(const a2m::GlobalForwardArgs& a) {
  constexpr size_t bytes = fwd_smem_bytes<T, HD, MASK>();
  const cudaError_t err = cudaFuncSetAttribute(global_attention_fwd_kernel<T, HD, MASK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.G);
  global_attention_fwd_kernel<T, HD, MASK><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.bits), static_cast<const int*>(a.seed),
      static_cast<T*>(a.out), a.S, a.H, a.valid_len, a.block, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const a2m::GlobalForwardArgs& a, int hd) {
  switch (hd) {
    case 16: return launch<T, 16, kMaskNone>(a);
    case 32: return launch<T, 32, kMaskNone>(a);
    case 64: return launch<T, 64, kMaskNone>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t a2m::global_attention_forward(const a2m::GlobalForwardArgs& a, int hd, int dtype) {
  if (a.bits != nullptr || a.seed != nullptr || a.S <= 0 || a.valid_len <= 0 ||
      a.valid_len > a.S || a.block < 0)
    return cudaErrorInvalidValue;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
