// Backward of the global (optionally block-diagonal) attention over the
// natural (G, S, H*hd) layout: dq, dk, dv from q, k, v and the output
// cotangent g, optionally with the dropout mask the forward applied.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py nhd_grads (:1104, both
// pallas_call sites: _nhd_bwd_kernel and, with bits, _nhd_bwd_kernel_drop)
// and nhd_grads_prng (:1833, _nhd_bwd_kernel_drop_prng), all of them
// _nhd_bwd_core -> _core_grads, :880-920.  The mask source is a template
// parameter of the one body, as in global_attention_fwd.cuh: none, precomputed
// uint8 bits, or Philox bytes drawn from the forward's seed -- the same byte
// at the same (row, column), though the dq kernel tiles by query rows and
// the dkv kernel by key rows (philox.cuh).  Per head, with every product
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
// 28.7 MB in bf16, 57.3 MB in f32 -- and the math needs five S x S x hd
// products per head, 5.1 GFLOP: on the tensor cores (989 TFLOP/s bf16) the
// bf16 case is bound by its bytes, f32 (67 TFLOP/s outside them) by its
// operations.  The kernels recompute the logits and dw in each of three
// passes, so they issue nine products, not five, and take three passes of
// expf over S x S per head; with the products on tensor cores the exp, the
// mask bytes and the tile copies set the pace.
//
// What the design does:
//   * Two kernels, no atomics, so results repeat bit for bit.  A row's
//     softmax statistics must be known before any dlogits of that row, dq
//     reduces over key tiles, and dk / dv over query tiles:
//       dq kernel  -- one block per (64-query tile, head, sample).  Pass 1
//                     walks the key tiles with an online softmax for the
//                     row max m, the row sum l and delta = sum_c dw w, and
//                     stores (m, 1/l, delta) in a small fp32 scratch; pass 2
//                     walks them again for dq.
//       dkv kernel -- one block per (64-key tile, head, sample) walks the
//                     query tiles, reads the rows' statistics from the
//                     scratch and accumulates dk and dv in registers.
//   * The products run on the tensor cores with warp-level mma.sync: bf16
//     m16n8k16 fed by ldmatrix (.trans for the operands stored k-major), f32
//     as 3xTF32 m16n8k8 (each operand split into a tf32 high and low part,
//     hi.hi + hi.lo + lo.hi with fp32 accumulation: ~1e-6 relative, where
//     plain TF32 keeps three digits).  Four warps own 16 rows each of the
//     block's tile: query rows in the dq kernel, key rows in the dkv kernel,
//     which computes S^T = K . Q^T and dW^T = V . G^T.  A row's values then
//     sit in one quad of lanes, so row reductions are two shuffles, and the
//     rounded dlogits and weights feed the next product straight from the
//     accumulator registers as A fragments (in f32 with the depth order
//     permuted to the accumulator's, and the B rows loaded to match).  The
//     resident tile (Q, G or K, V) lives in registers as A fragments.
//   * Tiles stay in shared memory in the working dtype, rows padded by 16
//     bytes so that ldmatrix (bf16) and the 32-bit fragment loads (f32) are
//     free of bank conflicts.  The streamed pair (K, V in the dq kernel; Q,
//     G and the rows' statistics in the dkv kernel) is copied with 16-byte
//     cp.async into two stages, rows at or past S zero-filled, so the next
//     tile's copy and the mask tile's fill overlap this tile's math.
//     round_T(q * scale) is applied by each thread to the chunks it copied,
//     once they land.  At hd 64 a block takes ~60 KB in bf16 (3 blocks of
//     128 threads to an SM) and ~110 KB in f32 (2 blocks).
// Masking keeps the forward's semantics: the fill is the finite -1e30, so a
// row whose every column is masked has uniform weights 1/S; its dlogits are
// masked to 0 (dq = dk = 0) while dv still receives g / S from it.  Columns
// past S never count.  valid_len masks columns only.  With block > 0 every
// tile is still walked (a fully masked row needs all of them); skipping the
// tiles outside a row's block is later work.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace a2m {

// The launch arguments of the two kernels, as the C entry receives them.
struct GlobalGradsArgs {
  const void *q, *k, *v, *g, *bits, *seed;
  void *dq, *dk, *dv, *stats;
  int G, S, H, valid_len, block, threshold;
  float scale;
  cudaStream_t stream;
};

// The launches of one dtype, in global_attention_bwd_{f32,bf16}.cu: the
// instantiations of each dtype compile in parallel.
cudaError_t global_attention_grads_f32(const GlobalGradsArgs& a, int hd);
cudaError_t global_attention_grads_bf16(const GlobalGradsArgs& a, int hd);

}  // namespace a2m

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh)

template <typename T, int HD, int MASK>
constexpr size_t dq_smem_bytes() {
  // Q, G, and two stages of K, V; with dropout, the mask bytes of a tile.
  return sizeof(T) * 6 * kTile * pitch<T, HD>() +
         (MASK == a2m::kMaskNone ? 0 : a2m::kMaskTile * a2m::kMaskPitch);
}

template <typename T, int HD, int MASK>
constexpr size_t dkv_smem_bytes() {
  // K, V, two stages of Q, G and of the rows' (m, 1/l, delta); the mask bytes.
  return sizeof(T) * 6 * kTile * pitch<T, HD>() + sizeof(float) * 2 * 3 * kTile +
         (MASK == a2m::kMaskNone ? 0 : a2m::kMaskTile * a2m::kMaskPitch);
}

// stats: (G, H, 3, S) fp32 -- row max, 1 / row sum, delta.
template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)  // blocks to an SM at hd 64
global_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const uint8_t* __restrict__ bits, const int* __restrict__ seed,
                           T* __restrict__ dq, float* __restrict__ stats, int S, int H,
                           int valid_len, int block, int threshold, float scale) {
  static_assert(kTile == a2m::kMaskTile, "mask tile is 64 x 64");
  constexpr int kLd = pitch<T, HD>();
  constexpr int kElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sG = sQ + kElems;
  T* sK = sG + kElems;          // stage s at sK + s * kElems
  T* sV = sK + 2 * kElems;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kElems);

  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int q0 = blockIdx.x * kTile;
  const int rows[2] = {q0 + m0 + grp, q0 + m0 + grp + 8};
  const bool live = q0 + m0 < S;           // the warp has a row below S
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const a2m::MaskPlane plane =
      a2m::make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
  const int row_block[2] = {block > 0 ? rows[0] / block : 0, block > 0 ? rows[1] / block : 0};

  copy_tile<T, HD>(sQ, q, base, row_stride, q0, S);
  copy_tile<T, HD>(sG, g, base, row_stride, q0, S);
  copy_tile<T, HD>(sK, k, base, row_stride, 0, S);
  copy_tile<T, HD>(sV, v, base, row_stride, 0, S);
  cp_commit();
  cp_wait<0>();
  scale_own_pieces<T, HD>(sQ, scale);
  __syncthreads();
  const Resident<T, HD> rq(sQ, m0), rg(sG, m0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Pass 1 is steps 0 .. tiles - 1, pass 2 steps tiles .. 2 tiles - 1.
  const int tiles = (S + kTile - 1) / kTile;
  for (int step = 0; step < 2 * tiles; ++step) {
    const int stage = step & 1;
    const int k0 = (step < tiles ? step : step - tiles) * kTile;
    if (step + 1 < 2 * tiles) {  // the next tile into the other stage
      const int next = ((step + 1) % tiles) * kTile;
      copy_tile<T, HD>(sK + (stage ^ 1) * kElems, k, base, row_stride, next, S);
      copy_tile<T, HD>(sV + (stage ^ 1) * kElems, v, base, row_stride, next, S);
    }
    cp_commit();
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    cp_wait<1>();
    __syncthreads();

    if (step == tiles) {  // the statistics are complete
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv_l[r] = 1.f / l[r];
        delta[r] = dsum[r] * inv_l[r];
        if (rows[r] < S && quad == 0) {
          float* head_stats = stats + head * 3 * S;
          head_stats[rows[r]] = m[r];
          head_stats[S + rows[r]] = inv_l[r];
          head_stats[2 * S + rows[r]] = delta[r];
        }
      }
    }
    const T* tK = sK + stage * kElems;
    const T* tV = sV + stage * kElems;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      if (!live) break;  // columns past S add nothing: no branch per chunk
      float s[2][4], dw[2][4];
      chunk_product<T, HD>(s, rq, tK, c0);
      chunk_product<T, HD>(dw, rg, tV, c0);
      bool keep[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = c0 + 8 * j + 2 * quad + (e & 1), col = k0 + c;
          keep[j][e] = col < valid_len && (block <= 0 || row_block[r] == col / block);
          s[j][e] = col >= S ? -INFINITY : (keep[j][e] ? s[j][e] : kMaskFill);
          if (MASK != a2m::kMaskNone) {
            const int byte = sMask[(m0 + grp + 8 * r) * a2m::kMaskPitch + c];
            dw[j][e] = a2m::apply_mask_byte(dw[j][e], byte, threshold, keep_inv);
          }
        }
      if (step < tiles) {
        // Online softmax statistics and delta = sum_c dw w.  The first chunk
        // holds column 0, so m is finite from then on, and a chunk wholly
        // past S (all -inf) leaves m, l and the sum as they were.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float cmax = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(cmax));
          const float alpha = expf(m[r] - m_new);
          float psum = 0.f, pdw = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float p = expf(s[j][e] - m_new);
              psum += p;
              pdw = fmaf(p, dw[j][e], pdw);
            }
          l[r] = l[r] * alpha + quad_sum(psum);
          dsum[r] = dsum[r] * alpha + quad_sum(pdw);
          m[r] = m_new;
        }
      } else {
        // dq += round_T(dlogits) . k; keep implies col < S.
        float dl[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float w = expf(s[j][e] - m[r]) * inv_l[r];
            dl[j][e] = keep[j][e] ? w * (dw[j][e] - delta[r]) : 0.f;
          }
        accumulate_product<T, HD>(acc, dl, tK, c0);
      }
    }
    __syncthreads();  // this stage and the mask tile are read; both may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    T* out = dq + base + rows[r] * row_stride + 2 * quad;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair<T>(out + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)  // blocks to an SM at hd 64
global_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const uint8_t* __restrict__ bits, const int* __restrict__ seed,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const float* __restrict__ stats, int S, int H, int valid_len,
                            int block, int threshold, float scale) {
  constexpr int kLd = pitch<T, HD>();
  constexpr int kElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kElems;
  T* sQ = sV + kElems;           // stage s at sQ + s * kElems
  T* sG = sQ + 2 * kElems;
  float* sStat = reinterpret_cast<float*>(sG + 2 * kElems);  // [stage][m, 1/l, delta][row]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sStat + 2 * 3 * kTile);

  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // the warp's key rows in the tile
  const int k0 = blockIdx.x * kTile;
  const int keys[2] = {k0 + m0 + grp, k0 + m0 + grp + 8};
  const bool live = k0 + m0 < S;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const a2m::MaskPlane plane =
      a2m::make_mask_plane<MASK>(bits, seed, blockIdx.z, blockIdx.y, H, S);
  const float* head_stats = stats + head * 3 * S;
  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
  bool key_in[2];   // below valid_len: the column counts unless its block differs
  int key_block[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_in[r] = keys[r] < valid_len;
    key_block[r] = block > 0 ? keys[r] / block : 0;
  }

  // The query tile q0 and its rows' statistics into a stage.
  auto copy_queries = [&](int stage, int q0) {
    copy_tile<T, HD>(sQ + stage * kElems, q, base, row_stride, q0, S);
    copy_tile<T, HD>(sG + stage * kElems, g, base, row_stride, q0, S);
    for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
      const int which = i / kTile, row = q0 + i % kTile;
      cp_async4(sStat + stage * 3 * kTile + i, head_stats + which * S + (row < S ? row : 0),
                row < S);
    }
  };

  copy_tile<T, HD>(sK, k, base, row_stride, k0, S);
  copy_tile<T, HD>(sV, v, base, row_stride, k0, S);
  copy_queries(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const Resident<T, HD> rk(sK, m0), rv(sV, m0);

  float acc_dk[HD / 8][4], acc_dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  const int tiles = (S + kTile - 1) / kTile;
  for (int step = 0; step < tiles; ++step) {
    const int stage = step & 1;
    const int q0 = step * kTile;
    if (step + 1 < tiles) copy_queries(stage ^ 1, q0 + kTile);
    cp_commit();
    a2m::fill_mask_tile<MASK>(sMask, plane, q0, k0, S);
    cp_wait<1>();
    T* tQ = sQ + stage * kElems;
    scale_own_pieces<T, HD>(tQ, scale);
    __syncthreads();

    const T* tG = sG + stage * kElems;
    const float* tStat = sStat + stage * 3 * kTile;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      if (!live) break;  // rows past S add nothing: no branch per chunk
      float s[2][4], dw[2][4];
      chunk_product<T, HD>(s, rk, tQ, c0);   // S^T: key rows, query columns
      chunk_product<T, HD>(dw, rv, tG, c0);  // dW^T
      float wu[2][4], dl[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = c0 + 8 * j + 2 * quad + (e & 1), row = q0 + c;
          const bool keep = key_in[r] && (block <= 0 || row / block == key_block[r]);
          // Rows past S have zero statistics; they must not count.
          const float w = row < S ? expf((keep ? s[j][e] : kMaskFill) - tStat[c]) *
                                        tStat[kTile + c]
                                  : 0.f;
          float w_used = w, gv = dw[j][e];
          if (MASK != a2m::kMaskNone) {
            const int byte = sMask[c * a2m::kMaskPitch + m0 + grp + 8 * r];
            w_used = a2m::apply_mask_byte(w, byte, threshold, keep_inv);
            gv = a2m::apply_mask_byte(gv, byte, threshold, keep_inv);
          }
          wu[j][e] = w_used;
          dl[j][e] = keep ? w * (gv - tStat[2 * kTile + c]) : 0.f;
        }
      accumulate_product<T, HD>(acc_dv, wu, tG, c0);
      accumulate_product<T, HD>(acc_dk, dl, tQ, c0);
    }
    __syncthreads();  // this stage and the mask tile are read; both may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
    const long long off = base + keys[r] * row_stride + 2 * quad;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store_pair<T>(dk + off + 8 * n, acc_dk[n][2 * r], acc_dk[n][2 * r + 1]);
      store_pair<T>(dv + off + 8 * n, acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
    }
  }
}



template <typename T, int HD, int MASK>
cudaError_t launch(const a2m::GlobalGradsArgs& a) {
  constexpr size_t dq_bytes = dq_smem_bytes<T, HD, MASK>();
  constexpr size_t dkv_bytes = dkv_smem_bytes<T, HD, MASK>();
  cudaError_t err = cudaFuncSetAttribute(global_attention_dq_kernel<T, HD, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(global_attention_dkv_kernel<T, HD, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.G);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *g = static_cast<const T*>(a.g);
  const uint8_t* bits = static_cast<const uint8_t*>(a.bits);
  const int* seed = static_cast<const int*>(a.seed);
  global_attention_dq_kernel<T, HD, MASK><<<grid, kThreads, dq_bytes, a.stream>>>(
      q, k, v, g, bits, seed, static_cast<T*>(a.dq), static_cast<float*>(a.stats), a.S, a.H,
      a.valid_len, a.block, a.threshold, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  global_attention_dkv_kernel<T, HD, MASK><<<grid, kThreads, dkv_bytes, a.stream>>>(
      q, k, v, g, bits, seed, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<const float*>(a.stats), a.S, a.H, a.valid_len, a.block, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const a2m::GlobalGradsArgs& a) {
  if (a.bits != nullptr) return launch<T, HD, a2m::kMaskBits>(a);
  if (a.seed != nullptr) return launch<T, HD, a2m::kMaskPhilox>(a);
  return launch<T, HD, a2m::kMaskNone>(a);
}

template <typename T>
cudaError_t dispatch_hd(const a2m::GlobalGradsArgs& a, int hd) {
  switch (hd) {
    case 16: return dispatch_mask<T, 16>(a);
    case 32: return dispatch_mask<T, 32>(a);
    case 64: return dispatch_mask<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
