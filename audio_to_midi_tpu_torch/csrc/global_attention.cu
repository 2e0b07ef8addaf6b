// The C entry of the global attention forward over the natural (G, S, H*hd)
// layout, TPU kernels 1, 4 and 15 of audio_to_midi_tpu/ops/pallas_attention.py,
// and the scalar body that kernels 4 and 15 still run on.
//
// Without a mask source (fused_attention_nhd, :140 -> :154: kernel 1) the
// entry launches the tensor-core forward of global_attention_fwd.cu, which
// also serves kernel 3; its header says what bounds it and what its design
// does.  With a dropout mask source it launches the scalar body below:
// precomputed uint8 bits (G, H, S, S) (fused_attention_nhd_dropout, :381:
// kernel 4) or Philox bytes drawn in the kernel from a seed in device memory
// (_nhd_drop_prng_impl, :1783: kernel 15; stream = (sample, head)), the
// `get_bits` of the TPU's _nhd_core (:74-137).  Per head: logits =
// (q * 1/sqrt(hd), scaled in q's dtype) . k^T in fp32; columns at or past
// valid_len, and outside the row's block when block > 0, are filled with
// -1e30; fp32 softmax; the mask on the weights; weights . v in fp32.
//
// The scalar body and what bounds it: one block of 256 threads per
// (64-query tile, head, sample), 4 threads per query row (the row max and sum
// reduce with two shuffles, hd/4 output accumulators each in registers); K
// and V tiles of 64 keys converted to fp32 in shared memory, element by
// element, and an online softmax over them.  Both products are fp32 FMA
// loops that read their operands from shared memory (the weights through a
// 64 x 65 tile), with no tensor core, so bf16 runs at f32's speed: bound by
// those shared-memory reads and by latency, far below both roofs.  Kernels 4
// and 15 move onto the tensor-core body as its bits and Philox mask sources
// next, and this body goes then.
//
// Masking keeps the TPU kernel's semantics exactly: a masked logit is the
// finite -1e30 (not -inf), so a row whose every column is masked softmaxes
// uniformly over all S columns, while columns past S never count.  With
// the running max starting at -inf, an all-masked tile yields max -1e30 and
// weight 1 per masked column; the first unmasked tile then rescales them by
// exp(-1e30 - m) = 0.  The mask bytes of a 64 x 64 tile go to shared memory
// beside its K and V rows -- read from the bits (8 MB per call at 32 x 4 x
// 250 x 250, more than q, k, v and out together in bf16) or drawn, one
// Philox call per 16 columns of a row.  With the online softmax the row sum
// runs over the undropped exponentials; the mask and its 256 / (256 -
// threshold) go on the term that multiplies v.  A fully masked row keeps its
// uniform weights and is dropped like any other.

#include <math.h>

#include "common.cuh"
#include "global_attention_fwd.cuh"
#include "philox.cuh"

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kThreads = 256;      // 4 threads per query row
constexpr float kMaskFill = -1e30f;

template <int HD, int MASK>
constexpr size_t smem_bytes() {
  // Q and K tiles padded by one column against bank conflicts, V tile, and
  // the probabilities of the current key tile; with dropout, its mask bytes.
  return sizeof(float) *
             (kTileQ * (HD + 1) + kTileK * (HD + 1) + kTileK * HD + kTileQ * (kTileK + 1)) +
         (MASK == a2m::kMaskNone ? 0 : a2m::kMaskTile * a2m::kMaskPitch);
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads)
global_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ bits,
                        const int* __restrict__ seed, T* __restrict__ out, int S, int H,
                        int valid_len, int block, int threshold, float scale) {
  static_assert(kTileQ == a2m::kMaskTile && kTileK == a2m::kMaskTile, "mask tile is 64 x 64");
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileQ * (HD + 1);
  float* sV = sK + kTileK * (HD + 1);
  float* sP = sV + kTileK * HD;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sP + kTileQ * (kTileK + 1));
  const a2m::MaskPlane plane =
      a2m::make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));

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
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
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
      tile_sum += p;
      const int c = part + 4 * j;
      sP[r * (kTileK + 1) + c] =
          MASK == a2m::kMaskNone
              ? p
              : a2m::apply_mask_byte(p, sMask[r * a2m::kMaskPitch + c], threshold, keep_inv);
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

struct Args {
  const void *q, *k, *v, *bits, *seed;
  void* out;
  int G, S, H, valid_len, block, threshold;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int MASK>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<HD, MASK>();
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<T, HD, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTileQ - 1) / kTileQ, a.H, a.G);
  global_attention_kernel<T, HD, MASK><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.bits), static_cast<const int*>(a.seed),
      static_cast<T*>(a.out), a.S, a.H, a.valid_len, a.block, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const Args& a) {
  if (a.bits != nullptr) return launch<T, HD, a2m::kMaskBits>(a);
  return launch<T, HD, a2m::kMaskPhilox>(a);
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return dispatch_mask<T, 16>(a);
    case 32: return dispatch_mask<T, 32>(a);
    case 64: return dispatch_mask<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (G, S, H*hd) device buffers of one dtype.  At
// most one of bits (contiguous (G, H, S, S) uint8) and seed ((2,) int32 in
// device memory) is given, with threshold in (0, 256); both null: no
// dropout, the tensor-core forward (global_attention_fwd.cu), which takes
// 16-byte aligned buffers only (else cudaErrorMisalignedAddress).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int a2m_global_attention(const void* q, const void* k, const void* v,
                                    const void* bits, const void* seed, void* out, int G, int S,
                                    int H, int hd, int valid_len, int block, int threshold,
                                    float scale, int dtype, void* stream) {
  const bool dropout = bits != nullptr || seed != nullptr;
  if ((bits != nullptr && seed != nullptr) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  if (!dropout) {
    const a2m::GlobalForwardArgs f = {q, k, v, nullptr, nullptr, out, G, S, H, valid_len,
                                      block, 0, scale, static_cast<cudaStream_t>(stream)};
    return a2m::global_attention_forward(f, hd, dtype);
  }
  const Args a = {q, k, v, bits, seed, out, G, S, H, valid_len, block, threshold, scale,
                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* a2m_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
