// Backward of the global (optionally block-diagonal) attention over the
// natural (G, S, H*hd) layout: dq, dk, dv from q, k, v and the output
// cotangent g, optionally with the dropout mask the forward applied.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py nhd_grads (:1104, both
// pallas_call sites: _nhd_bwd_kernel and, with bits, _nhd_bwd_kernel_drop)
// and nhd_grads_prng (:1833, _nhd_bwd_kernel_drop_prng), all of them
// _nhd_bwd_core -> _core_grads, :880-920.  The mask source is a template
// parameter of the one body, as in global_attention.cu: none, precomputed
// uint8 bits, or Philox bytes drawn from the forward's seed -- the same byte
// at the same (row, column), though the dq kernel tiles by query rows and
// the dkv kernel by key columns (philox.cuh).  Per head, with every product
// accumulated in fp32 and T the working dtype:
//   logits = round_T(q * scale) . k^T, masked logits -1e30, w = softmax;
//   w_used = bits ? (bits >= threshold ? w * 256/(256-threshold) : 0) : w;
//   dv = round_T(w_used)^T . g;      dw = g . v^T (dropped the same way);
//   dlogits = round_T(mask ? w * (dw - sum_c dw w) : 0);
//   dq = (dlogits . k) * scale;      dk = dlogits^T . round_T(q * scale).
// The roundings are the TPU kernel's: in bf16 they decide whether the two
// agree to rounding or not.
//
// What bounds it on the card: at the training shapes (G = 32 windows,
// S = 250, 4 heads x 64) it reads 4 and writes 3 tensors of G x S x 256 --
// 28.7 MB in bf16, 57.3 MB in f32 -- and does five S x S x hd products per
// head, 5.1 GFLOP.  With scalar fp32 FMAs (67 TFLOP/s peak) the arithmetic
// bounds it in both dtypes; on tensor cores the bf16 case would be bound by
// its bytes.  The kernel also recomputes the logits and dw in each of its
// three passes, so it issues ~9 products, not 5.
//
// What the design does about the two troubles of this backward:
//   * The TPU kernel holds the S x S weights of a head in VMEM.  An SM has
//     227 KB, so the kernels tile 64 x 64 as the forward does and recompute
//     a tile's weights from q and k wherever they are needed.
//   * A row's softmax statistics must be known before any dlogits of that
//     row, dq reduces over key tiles, and dk/dv reduce over query tiles.
//     Two kernels, no atomics, so results repeat bit for bit:
//       dq kernel  -- one block per (64-query tile, head, sample).  Pass 1
//                     walks the key tiles with an online softmax for the
//                     row max m, the row sum l and delta = sum_c dw w, and
//                     stores (m, 1/l, delta) in a small fp32 scratch; pass 2
//                     walks them again for dq.
//       dkv kernel -- one block per (64-key tile, head, sample) walks the
//                     query tiles, reads the rows' statistics from the
//                     scratch and accumulates dk and dv in registers.
//     4 threads own one row (dq kernel) or one key column (dkv kernel), so
//     reductions are two shuffles and each thread keeps hd/4 accumulators
//     per output.
// Masking keeps the forward's semantics: the fill is the finite -1e30, so a
// row whose every column is masked has uniform weights 1/S; its dlogits are
// masked to 0 (dq = dk = 0) while dv still receives g / S from it.  Columns
// past S never count.  valid_len masks columns only.  With block > 0 every
// tile is still walked (a fully masked row needs all of them); skipping the
// tiles outside a row's block is later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTile = 64;          // query rows and key columns per tile
constexpr int kThreads = 256;      // 4 threads per row (or key column)
constexpr int kPer = kTile / 4;    // tile entries per thread
constexpr float kMaskFill = -1e30f;

// Loads `rows` rows starting at row0 of one head into a padded fp32 tile;
// rows at or past S are zero.  Scaled: round_T(x * scale), else x.
template <typename T, int HD, bool Scaled>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long base, long long row_stride, int row0,
                                          int S, float scale) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S) {
      const T raw = src[base + row * row_stride + d];
      x = Scaled ? a2m::scaled_in_dtype(raw, scale) : a2m::to_float(raw);
    }
    dst[r * (HD + 1) + d] = x;
  }
}

template <int HD, int MASK>
constexpr size_t dq_smem_bytes() {
  // Q, G, K, V tiles padded by one column against bank conflicts, the
  // dlogits of the current key tile and, with dropout, its mask bytes.
  return sizeof(float) * (4 * kTile * (HD + 1) + kTile * (kTile + 1)) +
         (MASK == a2m::kMaskNone ? 0 : a2m::kMaskTile * a2m::kMaskPitch);
}

template <int HD, int MASK>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, G tiles, the rounded weights and dlogits of the current query
  // tile (stored key-major), the three statistics of its rows and, with
  // dropout, the tile's mask bytes.
  return sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile * (kTile + 1) + 3 * kTile) +
         (MASK == a2m::kMaskNone ? 0 : a2m::kMaskTile * a2m::kMaskPitch);
}

// stats: (G, H, 3, S) fp32 -- row max, 1 / row sum, delta.
template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads)
global_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const uint8_t* __restrict__ bits, const int* __restrict__ seed,
                           T* __restrict__ dq, float* __restrict__ stats, int S, int H,
                           int valid_len, int block, int threshold, float scale) {
  static_assert(kTile == a2m::kMaskTile, "mask tile is 64 x 64");
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kTile * (HD + 1);
  float* sK = sG + kTile * (HD + 1);
  float* sV = sK + kTile * (HD + 1);
  float* sP = sV + kTile * (HD + 1);
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sP + kTile * (kTile + 1));

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const a2m::MaskPlane plane =
      a2m::make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));

  load_tile<T, HD, true>(sQ, q, base, row_stride, q0, S, scale);
  load_tile<T, HD, false>(sG, g, base, row_stride, q0, S, 0.f);

  const int r = tid >> 2;     // query row within the tile
  const int part = tid & 3;   // this thread's share of the row
  const int row = q0 + r;
  constexpr int kDims = HD / 4;

  // One key tile's logits and (dropped) dw for this thread's columns.
  auto tile_terms = [&](int k0, float (&s)[kPer], float (&dw)[kPer], bool (&keep)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = part + 4 * j;
      const int col = k0 + c;
      float qk = 0.f;
      float gv = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        qk = fmaf(sQ[r * (HD + 1) + d], sK[c * (HD + 1) + d], qk);
        gv = fmaf(sG[r * (HD + 1) + d], sV[c * (HD + 1) + d], gv);
      }
      keep[j] = col < valid_len && (block <= 0 || row / block == col / block);
      s[j] = col >= S ? -INFINITY : (keep[j] ? qk : kMaskFill);
      if (MASK != a2m::kMaskNone)
        gv = a2m::apply_mask_byte(gv, sMask[r * a2m::kMaskPitch + c], threshold, keep_inv);
      dw[j] = gv;
    }
  };

  // Pass 1: online softmax statistics and delta = sum_c dw w.
  float m = -INFINITY;
  float l = 0.f;
  float dsum = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // Q, G in place; the previous tile's reads are done
    load_tile<T, HD, false>(sK, k, base, row_stride, k0, S, 0.f);
    load_tile<T, HD, false>(sV, v, base, row_stride, k0, S, 0.f);
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    __syncthreads();

    float s[kPer];
    float dw[kPer];
    bool keep[kPer];
    tile_terms(k0, s, dw, keep);
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) tile_max = fmaxf(tile_max, s[j]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);  // finite: column k0 < S is in every tile
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
    float tile_dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = expf(s[j] - m_new);
      tile_sum += p;
      tile_dsum = fmaf(p, dw[j], tile_dsum);
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    tile_dsum += __shfl_xor_sync(0xffffffffu, tile_dsum, 1);
    tile_dsum += __shfl_xor_sync(0xffffffffu, tile_dsum, 2);
    l = l * alpha + tile_sum;
    dsum = dsum * alpha + tile_dsum;
    m = m_new;
  }
  const float inv_l = 1.f / l;
  const float delta = dsum * inv_l;
  if (row < S && part == 0) {
    float* head_stats = stats + head * 3 * S;
    head_stats[row] = m;
    head_stats[S + row] = inv_l;
    head_stats[2 * S + row] = delta;
  }

  // Pass 2: dq = (dlogits . k) * scale.
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_tile<T, HD, false>(sK, k, base, row_stride, k0, S, 0.f);
    load_tile<T, HD, false>(sV, v, base, row_stride, k0, S, 0.f);
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    __syncthreads();

    float s[kPer];
    float dw[kPer];
    bool keep[kPer];
    tile_terms(k0, s, dw, keep);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float w = expf(s[j] - m) * inv_l;  // 0 for columns past S
      const float dl = keep[j] ? w * (dw[j] - delta) : 0.f;  // keep implies col < S
      sP[r * (kTile + 1) + part + 4 * j] = a2m::round_to<T>(dl);
    }
    __syncwarp();  // a row's dlogits are written and read by its own 4 lanes
    for (int c = 0; c < kTile; ++c) {
      const float dl = sP[r * (kTile + 1) + c];
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(dl, sK[c * (HD + 1) + part + 4 * i], acc[i]);
    }
  }
  if (row < S) {
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      dq[base + row * row_stride + part + 4 * i] = a2m::from_float<T>(acc[i] * scale);
  }
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads)
global_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const uint8_t* __restrict__ bits, const int* __restrict__ seed,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const float* __restrict__ stats, int S, int H, int valid_len,
                            int block, int threshold, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (HD + 1);
  float* sQ = sV + kTile * (HD + 1);
  float* sG = sQ + kTile * (HD + 1);
  float* sW = sG + kTile * (HD + 1);        // [key][query] rounded weights
  float* sDL = sW + kTile * (kTile + 1);    // [key][query] rounded dlogits
  float* sM = sDL + kTile * (kTile + 1);
  float* sInvL = sM + kTile;
  float* sDelta = sInvL + kTile;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sDelta + kTile);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTile;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const a2m::MaskPlane plane =
      a2m::make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float* head_stats = stats + head * 3 * S;
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));

  load_tile<T, HD, false>(sK, k, base, row_stride, k0, S, 0.f);
  load_tile<T, HD, false>(sV, v, base, row_stride, k0, S, 0.f);

  const int c = tid >> 2;     // key column within the tile
  const int part = tid & 3;   // this thread's share of the column
  const int col = k0 + c;
  constexpr int kDims = HD / 4;
  float acc_dk[kDims];
  float acc_dv[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // K, V in place; the previous tile's reads are done
    load_tile<T, HD, true>(sQ, q, base, row_stride, q0, S, scale);
    load_tile<T, HD, false>(sG, g, base, row_stride, q0, S, 0.f);
    if (tid < kTile) {
      const int row = q0 + tid;
      const bool inside = row < S;
      sM[tid] = inside ? head_stats[row] : 0.f;
      sInvL[tid] = inside ? head_stats[S + row] : 0.f;
      sDelta[tid] = inside ? head_stats[2 * S + row] : 0.f;
    }
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int rr = part + 4 * j;
      const int row = q0 + rr;
      float qk = 0.f;
      float gv = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        qk = fmaf(sQ[rr * (HD + 1) + d], sK[c * (HD + 1) + d], qk);
        gv = fmaf(sG[rr * (HD + 1) + d], sV[c * (HD + 1) + d], gv);
      }
      const bool inside = row < S && col < S;
      const bool keep = col < valid_len && (block <= 0 || row / block == col / block);
      const float w = inside ? expf((keep ? qk : kMaskFill) - sM[rr]) * sInvL[rr] : 0.f;
      float w_used = w;
      if (MASK != a2m::kMaskNone) {
        const int byte = sMask[rr * a2m::kMaskPitch + c];
        w_used = a2m::apply_mask_byte(w, byte, threshold, keep_inv);
        gv = a2m::apply_mask_byte(gv, byte, threshold, keep_inv);
      }
      const float dl = inside && keep ? w * (gv - sDelta[rr]) : 0.f;
      sW[c * (kTile + 1) + rr] = a2m::round_to<T>(w_used);
      sDL[c * (kTile + 1) + rr] = a2m::round_to<T>(dl);
    }
    __syncwarp();  // a column's entries are written and read by its own 4 lanes
    for (int rr = 0; rr < kTile; ++rr) {
      const float w = sW[c * (kTile + 1) + rr];
      const float dl = sDL[c * (kTile + 1) + rr];
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = part + 4 * i;
        acc_dv[i] = fmaf(w, sG[rr * (HD + 1) + d], acc_dv[i]);
        acc_dk[i] = fmaf(dl, sQ[rr * (HD + 1) + d], acc_dk[i]);
      }
    }
  }
  if (col < S) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const long long off = base + col * row_stride + part + 4 * i;
      dk[off] = a2m::from_float<T>(acc_dk[i]);
      dv[off] = a2m::from_float<T>(acc_dv[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g, *bits, *seed;
  void *dq, *dk, *dv, *stats;
  int G, S, H, valid_len, block, threshold;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int MASK>
cudaError_t launch(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(global_attention_dq_kernel<T, HD, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem_bytes<HD, MASK>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(global_attention_dkv_kernel<T, HD, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem_bytes<HD, MASK>()));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.G);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *g = static_cast<const T*>(a.g);
  const uint8_t* bits = static_cast<const uint8_t*>(a.bits);
  const int* seed = static_cast<const int*>(a.seed);
  global_attention_dq_kernel<T, HD, MASK><<<grid, kThreads, dq_smem_bytes<HD, MASK>(), a.stream>>>(
      q, k, v, g, bits, seed, static_cast<T*>(a.dq), static_cast<float*>(a.stats), a.S, a.H,
      a.valid_len, a.block, a.threshold, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  global_attention_dkv_kernel<T, HD, MASK><<<grid, kThreads, dkv_smem_bytes<HD, MASK>(), a.stream>>>(
      q, k, v, g, bits, seed, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<const float*>(a.stats), a.S, a.H, a.valid_len, a.block, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const Args& a) {
  if (a.bits != nullptr) return launch<T, HD, a2m::kMaskBits>(a);
  if (a.seed != nullptr) return launch<T, HD, a2m::kMaskPhilox>(a);
  return launch<T, HD, a2m::kMaskNone>(a);
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

// q, k, v, g, dq, dk, dv: contiguous (G, S, H*hd) device buffers of one
// dtype.  At most one of bits (contiguous (G, H, S, S) uint8) and seed
// ((2,) int32 in device memory) is given, with threshold in (0, 256); both
// null: no dropout.  stats: fp32 scratch of G*H*3*S elements.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int a2m_global_attention_grads(const void* q, const void* k, const void* v,
                                          const void* g, const void* bits, const void* seed,
                                          void* dq, void* dk, void* dv, void* stats, int G,
                                          int S, int H, int hd, int valid_len, int block,
                                          int threshold, float scale, int dtype,
                                          void* stream) {
  const bool dropout = bits != nullptr || seed != nullptr;
  if ((bits != nullptr && seed != nullptr) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  const Args a = {q, k, v, g, bits, seed, dq, dk, dv, stats, G, S, H, valid_len, block,
                  threshold, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
