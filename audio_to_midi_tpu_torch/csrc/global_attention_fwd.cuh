// Forward of the global (optionally block-diagonal) attention on the tensor
// cores, over the natural (G, S, H*hd) layout.  One body for four TPU
// kernels of audio_to_midi_tpu/ops/pallas_attention.py, told apart by the
// template parameter MASK, the dropout mask source (philox.cuh):
//   * kernel 1, fused_attention_nhd (:140 -> pallas_call :154, body
//     _nhd_core :74-126), kMaskNone, through a2m_global_attention
//     (global_attention.cu) without a mask source;
//   * kernel 4, fused_attention_nhd_dropout (:381 -> :393), kMaskBits:
//     precomputed (G, H, S, S) uint8 bits;
//   * kernel 15, _nhd_drop_prng_impl (:1783 -> :1786), kMaskPhilox: the
//     bytes drawn in the kernel from a (2,) int32 seed in device memory,
//     stream (sample, head) -- the bytes philox_dump.cu (kernel 14) writes
//     for that seed, so kernels 15 and 4 on those bytes agree bit for bit;
//   * kernel 3, fused_attention (:219; _fused_attention_impl :170 ->
//     pallas_call :190, body _attention_kernel :36-64), kMaskNone, through
//     a2m_head_major_attention (head_major_attention.cu): a contiguous
//     head-major (G, H, S, hd) tensor is the natural layout (G*H, S, 1*hd),
//     so kernel 3 is this body on G*H samples of one head with valid_len = S.
//     The TPU kernel's packing of several heads into one cell is its VMEM
//     layout, not its function.
// The instantiations (2 dtypes x 3 head dims x 3 mask sources) are in
// global_attention_fwd_{f32,bf16}.cu, which compile in parallel; the entry
// that checks the arguments is global_attention_fwd.cu.
//
// Per head, with T the working dtype and every product accumulated in fp32:
//   logits = round_T(q * 1/sqrt(hd)) . k^T; a column at or past valid_len,
//   or outside the row's block of `block` rows when block > 0, is the finite
//   -1e30; columns at or past S never count; weights = softmax(logits);
//   with a mask source, a weight is kept where its byte >= threshold and
//   scaled by 256 / (256 - threshold) (the TPU's _apply_bits, :326-338),
//   else 0; out = weights . v, cast to T.
// The softmax is online over 64-column key tiles.  Each tile's unnormalised
// weights exp(s - m) are summed unmasked and unrounded into the fp32 row
// sum; the term that multiplies v is the weight through the mask, rounded
// to T (bf16: the TPU kernels' weights.astype(v.dtype) after the mask, :121
// and :63; f32: no rounding), and the output is divided by the row sum at
// the end.  The TPU rounds the normalised weight, this body the
// unnormalised one: a relative 2^-9 per weight in bf16.  A row whose every
// column is masked averages all S columns, as on the TPU (its logits are
// -1e30, not -inf), and is dropped like any other.
//
// What bounds it on this card.  At the serving shapes (B windows, S = 250,
// 4 heads x 64) the call reads q, k, v and writes out, 4 x B x 128 KB in
// bf16, and does 4 x B x 4 x 250^2 x 64 = 64 B MFLOP: at B = 128, 65.5 MB
// (19.6 us at 3.35 TB/s) and 8.2 GFLOP (8.3 us at 989 TFLOP/s) -- bf16 is
// bound by its bytes; f32 moves twice the bytes and, as 3xTF32, runs three
// tf32 products per product (50 us at 495 TFLOP/s).  Kernel 4 also reads the
// bits, S^2 bytes per head: 8 MB at the training shapes (32 windows), more
// than q, k, v and out together in bf16.  Kernel 15 instead draws them: one
// Philox4x32-10 call (ten rounds of two 32-bit multiplies) per 16 bytes.
// What the design does:
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
//     warp for 64 keys); the masks, the online-softmax rescale and the
//     dropout mask are applied there, and the weights are packed from those
//     registers straight into the A fragments of O += P . V: no weight tile
//     in shared memory;
//   * the mask bytes of a 64 x 64 tile go to shared memory, each byte
//     fetched or drawn once and read by the lanes that hold its weight.
//     The bits ride in the K / V copy of their tile, in its own two stages
//     (copy_mask_tile), so tile t + 1's bytes are in flight while tile t's
//     products run: a plane row is S bytes (250 at the model's shape), so
//     a row's 64 bytes need not start on a word; the copy takes the 17
//     aligned words that cover them, and a lane reads its bytes at the
//     row's skew (its start modulo 4).  The Philox draws are ALU work, 256
//     calls per tile shared by the 128 threads, made while the next tile's
//     copy is in flight (fill_mask_tile, one stage);
//   * the key tiles walked are those that hold a column some row of the
//     query tile can see: below valid_len and, with block > 0, inside the
//     rows' blocks.  Skipping the others is exact (each adds exp(-1e30 - m)
//     = 0, and the mask multiplies that 0) only where every row of the tile
//     has a column below valid_len, so with a fully masked row in the tile
//     every tile up to S is walked;
//   * no atomics: the same inputs give the same bits.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace a2m {

// q, k, v, out: (G, S, H*hd) in one dtype, each 16-byte aligned; valid_len
// in [1, S]; block >= 0.  At most one of bits (contiguous (G, H, S, S)
// uint8, any alignment) and seed ((2,) int32 in device memory), with
// threshold in (0, 256) when one is given; both null: no dropout.
struct GlobalForwardArgs {
  const void *q, *k, *v, *bits, *seed;
  void* out;
  int G, S, H, valid_len, block, threshold;
  float scale;
  cudaStream_t stream;
};

// Checks the arguments and launches the forward for head dim hd (16, 32 or
// 64) and dtype (DtypeCode); returns the cudaError_t of the launch:
// cudaErrorMisalignedAddress, with nothing launched, for a q, k, v or out
// that is not 16-byte aligned (global_attention_fwd.cu).
cudaError_t global_attention_forward(const GlobalForwardArgs& a, int hd, int dtype);

// The launches of one dtype, in global_attention_fwd_{f32,bf16}.cu.
cudaError_t global_attention_forward_f32(const GlobalForwardArgs& a, int hd);
cudaError_t global_attention_forward_bf16(const GlobalForwardArgs& a, int hd);

}  // namespace a2m

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh) and mask sources (philox.cuh)

// Shared stages of mask bytes: two for the bits, copied one tile ahead; one
// for the Philox draws.
template <int MASK>
constexpr int mask_stages() {
  return MASK == kMaskNone ? 0 : MASK == kMaskBits ? 2 : 1;
}

constexpr int kMaskStage = kMaskTile * kMaskPitch;
constexpr int kMaskWords = kMaskPitch / 4;  // 17 words: 64 bytes at any skew

// Where the bytes of plane row `row` start in their shared row: for the bits,
// copied by the word, the row's first byte modulo 4; for the draws, 0.
template <int MASK>
__device__ __forceinline__ int mask_skew(const MaskPlane& plane, int row, int P) {
  if (MASK != kMaskBits) return 0;
  return static_cast<int>((reinterpret_cast<uintptr_t>(plane.bits) +
                           static_cast<unsigned long long>(row) * P) & 3);
}

// Issues the cp.async of the mask bytes of rows row0 .. row0 + 63, columns
// col0 .. col0 + 63 (col0 a multiple of 64) of a P x P plane of bits: per
// row the aligned words that hold one of its bytes below P, at the row's
// skew; rows at or past P and words past a row's last byte are zero-filled
// and not read.  A word that holds a byte of the bits is mapped memory:
// device allocations start and end on word bounds (PyTorch's caching
// allocator rounds them to 512 bytes).
__device__ __forceinline__ void copy_mask_tile(uint8_t* dst, const MaskPlane& plane, int row0,
                                               int col0, int P) {
  const int rows = min(P - row0, kMaskTile);   // the rows of the plane in the tile
  const int count = min(P - col0, kMaskTile);  // the bytes of a row that count
  const uint8_t* tile = plane.bits + static_cast<long long>(row0) * P + col0;
  // Not unrolled: unrolled, the bf16 hd 64 kernel spilled 20 bytes past its
  // 128 registers (ptxas).
#pragma unroll 1
  for (int i = threadIdx.x; i < kMaskTile * kMaskWords; i += kThreads) {
    const int r = i / kMaskWords, w = i % kMaskWords;
    const uint8_t* first = tile + (r < rows ? r : 0) * P;
    const uint8_t* word =
        reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t{3}) +
        4 * w;
    cp_async4(dst + r * kMaskPitch + 4 * w, word, r < rows && word < first + count);
  }
}

template <typename T, int HD, int MASK>
constexpr size_t fwd_smem_bytes() {
  // Q and two stages of K, V; the stages of mask bytes.
  return sizeof(T) * 5 * kTile * pitch<T, HD>() + mask_stages<MASK>() * kMaskStage;
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
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kElems);  // stage s at + s * kMaskStage

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
  // The lane's first mask byte of row grp in a stage; row grp + 8's is
  // 8 rows further, at the same skew (8 S bytes further in the plane).
  const int mask_at = (m0 + grp) * kMaskPitch + 2 * quad + mask_skew<MASK>(plane, rows[0], S);

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
  if (MASK == kMaskBits) copy_mask_tile(sMask, plane, q0, first * kTile, S);
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
      if (MASK == kMaskBits)  // the bits ride one tile ahead
        copy_mask_tile(sMask + (stage ^ 1) * kMaskStage, plane, q0, k0 + kTile, S);
    }
    cp_commit();
    if (MASK == kMaskPhilox) fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    cp_wait<1>();
    __syncthreads();

    if (live) {  // warp-uniform: a warp wholly past S has nothing to store
      const T* tK = sK + stage * kElems;
      const T* tV = sV + stage * kElems;
      const uint8_t* tMask = sMask + (MASK == kMaskBits ? stage * kMaskStage : 0);
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
              const int byte = tMask[mask_at + 8 * r * kMaskPitch + c * kChunk + 8 * j + (e & 1)];
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
cudaError_t forward_launch(const GlobalForwardArgs& a) {
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

template <typename T, int HD>
cudaError_t forward_mask(const GlobalForwardArgs& a) {
  if (a.bits != nullptr) return forward_launch<T, HD, kMaskBits>(a);
  if (a.seed != nullptr) return forward_launch<T, HD, kMaskPhilox>(a);
  return forward_launch<T, HD, kMaskNone>(a);
}

template <typename T>
cudaError_t forward_hd(const GlobalForwardArgs& a, int hd) {
  switch (hd) {
    case 16: return forward_mask<T, 16>(a);
    case 32: return forward_mask<T, 32>(a);
    case 64: return forward_mask<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
