// The tensor-core product of the ConvNeXt stage kernels (TPU kernels 19
// and 20, convnext_stage_fwd.cu and convnext_stage_bwd.cu) and of the fused
// transformer layers (TPU kernels 11, 17 and 18, fused_layer_impl.cuh):
// out(m, n) = sum_k A(m, k) B(k, n) over one chunk of the depth, handed to
// an epilogue functor by pairs of columns.
//
// Each operand is stored along the depth (K_CONTIG: element (i, k) at
// src[i * ld + k]) or across it (at src[k * ld + i]); the six products of a
// kernel-20 block take all four pairings, those of kernel 19 and of the
// fused layers activations along the depth and weights across it.  The design:
//   * warp-level mma.sync from mma_tile.cuh: bf16 m16n8k16 on the operands
//     as stored, fp32 accumulation; f32 as 3xTF32 m16n8k8, each fragment
//     split once per depth step and each depth step's three products added
//     to the sum with a rounded FADD (mma_3xtf32);
//   * a block tile of kMmaM x kMmaN = 128 x 64 outputs, 4 warps in a 2 x 2
//     grid, each 64 x 32 (4 x 4 m16n8 accumulators).  The row products of
//     stage 5 (R = 16,000 rows, 128 or 256 columns) give 250 or 500 blocks,
//     those of stage 6 (8,000 rows, 256 or 512 columns) 252 or 504: every
//     product fills the 132 SMs.  The weight-gradient products (128-512
//     square, the rows as depth) are split into row chunks by the caller;
//   * a depth tile of 64 bytes of a row (32 bf16, 16 f32 values), copied
//     with 16-byte cp.async into kMmaStages = 3 stages, two in flight while
//     the third is multiplied; rows and depth past their limit (R, the
//     chunk's end) are zero-filled, never read;
//   * shared tiles stored as the operand is, rows padded so that the
//     fragment loads are free of bank conflicts: a tile stored along the
//     depth by 16 bytes, one stored across it by 8 elements; bf16 fragments
//     by ldmatrix (.trans for a tile stored across the depth: B of the row
//     products, both operands of the weight-gradient products), f32
//     fragments by 32-bit loads;
//   * the epilogue reads what a thread's 16-row slice of outputs needs
//     (biases, the cotangent, the activation) as 4- or 8-byte pairs, all in
//     flight together, then writes that slice as pairs;
//   * the sum of an output runs in one thread in depth order, whatever the
//     grid: the same call gives the same bits.  No atomics;
//   * an operand whose rows do not start on 16 bytes (a width that does not
//     fill whole 16-byte pieces, a base off 16 bytes: no model path, but the
//     entries of kernel 19 and of the fused layers take any width) is
//     copied element by element (copy_elements), in the same kernel, where
//     its epilogue type says so (kElementCopies); kernel 20's epilogues do
//     not, and its instantiations compile as before.
#pragma once

#include <type_traits>

#include "convnext_stage.cuh"
#include "mma_tile.cuh"

namespace a2m {
namespace cnx {

constexpr int kMmaM = 128, kMmaN = 64;    // outputs of a block tile
constexpr int kMmaThreads = 128;          // 4 warps
constexpr int kMmaStages = 3;             // depth tiles in shared memory
constexpr int kWarpM = 64, kWarpN = 32;   // outputs of a warp
constexpr int kMi = kWarpM / 16, kNi = kWarpN / 8;
static_assert((kMmaM / kWarpM) * (kMmaN / kWarpN) * 32 == kMmaThreads, "one warp per warp tile");

// The shared tile of one operand: W rows (outputs) of the block tile by kK
// depth values.
template <typename T>
struct MmaTile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values per cp.async
  static constexpr int kK = 64 / static_cast<int>(sizeof(T));    // depth of a tile
  template <bool K_CONTIG, int W>
  __host__ __device__ static constexpr int pitch() { return K_CONTIG ? kK + kVec : W + 8; }
  template <bool K_CONTIG, int W>
  __host__ __device__ static constexpr int elems() {
    return (K_CONTIG ? W : kK) * pitch<K_CONTIG, W>();
  }
};

// The tile of rows i0 .. i0 + W - 1 and depth k0 .. k0 + kK - 1 of an
// operand into shared memory, stored as in device memory; zero where i >=
// ilim or k >= klim.  The limit along the contiguous dimension is a
// multiple of kVec.
template <typename T, bool K_CONTIG, int W>
__device__ __forceinline__ void copy_operand(T* dst, const T* __restrict__ src, int ld, int i0,
                                             int ilim, int k0, int klim) {
  using Tile = MmaTile<T>;
  constexpr int P = Tile::template pitch<K_CONTIG, W>();
  constexpr int kPieces = (K_CONTIG ? Tile::kK : W) / Tile::kVec;   // per stored row
  constexpr int kRows = K_CONTIG ? W : Tile::kK;
  static_assert(kRows * kPieces % kMmaThreads == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < kRows * kPieces / kMmaThreads; ++it) {
    const int p = threadIdx.x + it * kMmaThreads;
    const int r = p / kPieces, c = (p % kPieces) * Tile::kVec;
    const int i = K_CONTIG ? r : c, k = K_CONTIG ? c : r;
    const bool inside = i0 + i < ilim && k0 + k < klim;
    const size_t at = K_CONTIG ? static_cast<size_t>(i0 + i) * ld + k0 + k
                               : static_cast<size_t>(k0 + k) * ld + i0 + i;
    cp_async16(dst + r * P + c, src + (inside ? at : 0), inside);
  }
}

// copy_operand element by element, with plain loads and stores: for
// operands whose rows do not start on 16 bytes.  Synchronous, yet safe in the
// pipeline: the stage it fills was freed by the barrier at the top of the
// iteration, and is read after a later one.
template <typename T, bool K_CONTIG, int W>
__device__ __forceinline__ void copy_elements(T* dst, const T* __restrict__ src, int ld, int i0,
                                              int ilim, int k0, int klim) {
  using Tile = MmaTile<T>;
  constexpr int P = Tile::template pitch<K_CONTIG, W>();
  constexpr int kCols = K_CONTIG ? Tile::kK : W;   // per stored row
  constexpr int kRows = K_CONTIG ? W : Tile::kK;
  static_assert(kRows * kCols % kMmaThreads == 0, "whole copies per thread");
#pragma unroll 4
  for (int it = 0; it < kRows * kCols / kMmaThreads; ++it) {
    const int p = threadIdx.x + it * kMmaThreads;
    const int r = p / kCols, c = p % kCols;
    const int i = K_CONTIG ? r : c, k = K_CONTIG ? c : r;
    const bool inside = i0 + i < ilim && k0 + k < klim;
    const size_t at = K_CONTIG ? static_cast<size_t>(i0 + i) * ld + k0 + k
                               : static_cast<size_t>(k0 + k) * ld + i0 + i;
    dst[r * P + c] = inside ? src[at] : from_float<T>(0.f);
  }
}

// Whether an epilogue type asks for copy_elements (static constexpr bool
// kElementCopies = true); by default the tiles are copied by copy_operand.
template <typename Epi, typename = void>
struct ElementCopies : std::false_type {};

template <typename Epi>
struct ElementCopies<Epi, std::void_t<decltype(Epi::kElementCopies)>>
    : std::integral_constant<bool, Epi::kElementCopies> {};

// acc += the warp's 64 x 32 outputs of (A tile) . (B tile) over one depth
// tile.  wm, wn: the warp's first row and column in the block tile.
template <typename T, bool A_KC, bool B_KC>
struct WarpProduct;

template <bool A_KC, bool B_KC>
struct WarpProduct<__nv_bfloat16, A_KC, B_KC> {
  using T = __nv_bfloat16;
  using M = Mma<T>;
  using Tile = MmaTile<T>;
  static constexpr int kPA = Tile::template pitch<A_KC, kMmaM>();
  static constexpr int kPB = Tile::template pitch<B_KC, kMmaN>();

  // A of rows m0.. and depth k0.. of a tile stored [depth][row].
  static __device__ __forceinline__ void load_a_across(typename M::A& a, const T* tile, int m0,
                                                       int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + (j >> 1) * 8) * kPA + m0 + (j & 1) * 8);
  }

  static __device__ __forceinline__ void run(float (&acc)[kMi][kNi][4], const T* as,
                                             const T* bs, int wm, int wn) {
#pragma unroll
    for (int kk = 0; kk < Tile::kK; kk += M::kK) {
      typename M::A a[kMi];
      typename M::B b[kNi];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        if (A_KC) M::load_a(a[mi], as, kPA, wm + 16 * mi, kk);
        else load_a_across(a[mi], as, wm + 16 * mi, kk);
      }
#pragma unroll
      for (int nj = 0; nj < kNi / 2; ++nj) {
        typename M::B pair[2];
        if (B_KC) M::load_b(pair, bs, kPB, wn + 16 * nj, kk);
        else M::load_bt(pair, bs, kPB, kk, wn + 16 * nj);
#pragma unroll
        for (int e = 0; e < 2; ++e) b[2 * nj][e] = pair[0][e], b[2 * nj + 1][e] = pair[1][e];
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) M::mma(acc[mi][ni], a[mi], b[ni]);
    }
  }
};

// f32: m16n8k8 fragments of fp32 values (A: a0 (grp, quad), a1 (grp + 8,
// quad), a2 (grp, quad + 4), a3 (grp + 8, quad + 4); B: b0 (depth quad,
// column grp), b1 (quad + 4, grp)), split into tf32 high and low parts once
// per depth step.
template <bool A_KC, bool B_KC>
struct WarpProduct<float, A_KC, B_KC> {
  using T = float;
  using M = Mma<T>;
  using Tile = MmaTile<T>;
  static constexpr int kPA = Tile::template pitch<A_KC, kMmaM>();
  static constexpr int kPB = Tile::template pitch<B_KC, kMmaN>();

  static __device__ __forceinline__ void run(float (&acc)[kMi][kNi][4], const T* as,
                                             const T* bs, int wm, int wn) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
#pragma unroll
    for (int kk = 0; kk < Tile::kK; kk += M::kK) {
      uint32_t bh[kNi][2], bl[kNi][2];
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        float b[2];
        if (B_KC) {
          const T* p = bs + (wn + 8 * ni + grp) * kPB + kk + quad;
          b[0] = p[0], b[1] = p[4];
        } else {
          const T* p = bs + (kk + quad) * kPB + wn + 8 * ni + grp;
          b[0] = p[0], b[1] = p[4 * kPB];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(bh[ni][e], bl[ni][e], b[e]);
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        float a[4];
        if (A_KC) {
          M::load_a(a, as, kPA, wm + 16 * mi, kk);
        } else {
          const T* p = as + (kk + quad) * kPA + wm + 16 * mi + grp;
          a[0] = p[0], a[1] = p[8], a[2] = p[4 * kPA], a[3] = p[4 * kPA + 8];
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(ah[e], al[e], a[e]);
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) mma_3xtf32(acc[mi][ni], ah, al, bh[ni], bl[ni]);
      }
    }
  }
};

// Two values of a row at columns n, n + 1 (n even), widened to fp32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The pair (n, n + 1) of an epilogue that reads and writes element by
// element (ELEMS: its rows do not all start on 16 bytes), the second value
// only where `second` (n + 1 < N, an odd width's last column alone); by
// load_pair / store_pair otherwise.
template <bool ELEMS, typename T>
__device__ __forceinline__ float2 get2(const T* p, bool second) {
  if constexpr (ELEMS) return make_float2(to_float(p[0]), second ? to_float(p[1]) : 0.f);
  else return load_pair(p);
}

template <bool ELEMS, typename T>
__device__ __forceinline__ void put2(T* p, float x, float y, bool second) {
  if constexpr (ELEMS) {
    p[0] = from_float<T>(x);
    if (second) p[1] = from_float<T>(y);
  } else {
    store_pair<T>(p, x, y);
  }
}

// out(m, n) = sum_k A(m, k) B(n, k) over k in [z * chunk, (z + 1) * chunk)
// of [0, K), z = blockIdx.z, for m < M, n < N (N even, or an epilogue that
// stores the last column of an odd N alone), handed to the epilogue by column
// pairs: first in = epi.load(m, n) for the 8 pairs of a
// thread's 16-row slice, then epi.store(m, n, in, sum(m, n), sum(m, n + 1),
// z) for each.  The loads of a slice are in flight together: handed one
// element at a time, each load would wait for the stores before it, which
// the compiler must assume may alias it.
// A_KC / B_KC: each operand stored along k or across it (copy_operand, or
// copy_elements where ElementCopies<Epi>).
template <typename T, bool A_KC, bool B_KC, typename Epi>
__global__ void __launch_bounds__(kMmaThreads)
mma_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K, int lda,
                int ldb, int chunk, Epi epi) {
  using Tile = MmaTile<T>;
  constexpr int kA = Tile::template elems<A_KC, kMmaM>();
  constexpr int kStage = kA + Tile::template elems<B_KC, kMmaN>();
  static_assert(kA * sizeof(T) % 16 == 0 && kStage * sizeof(T) % 16 == 0, "aligned tiles");
  __shared__ __align__(16) unsigned char raw[kMmaStages * kStage * sizeof(T)];
  T* smem = reinterpret_cast<T*>(raw);

  const int m0 = blockIdx.x * kMmaM, n0 = blockIdx.y * kMmaN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int tiles = (k_end - k_begin + Tile::kK - 1) / Tile::kK;
  auto load = [&](int kt) {
    T* stage = smem + (kt % kMmaStages) * kStage;
    const int k0 = k_begin + kt * Tile::kK;
    if constexpr (ElementCopies<Epi>::value) {
      copy_elements<T, A_KC, kMmaM>(stage, A, lda, m0, M, k0, k_end);
      copy_elements<T, B_KC, kMmaN>(stage + kA, B, ldb, n0, N, k0, k_end);
    } else {
      copy_operand<T, A_KC, kMmaM>(stage, A, lda, m0, M, k0, k_end);
      copy_operand<T, B_KC, kMmaN>(stage + kA, B, ldb, n0, N, k0, k_end);
    }
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < tiles) load(s);
    cp_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * kWarpM, wn = (warp & 1) * kWarpN;
  float acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int kt = 0; kt < tiles; ++kt) {
    cp_wait<kMmaStages - 2>();  // tile kt has landed ...
    __syncthreads();            // ... for every thread, and tile kt - 1 is done with
    if (kt + kMmaStages - 1 < tiles) load(kt + kMmaStages - 1);  // into kt - 1's stage
    cp_commit();
    const T* stage = smem + (kt % kMmaStages) * kStage;
    WarpProduct<T, A_KC, B_KC>::run(acc, stage, stage + kA, wm, wn);
  }

  // Accumulator c[4] of an m16n8 tile: rows grp (c0, c1) and grp + 8 (c2,
  // c3), columns 2 quad and 2 quad + 1.
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  const int z = static_cast<int>(blockIdx.z);
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
    typename Epi::In in[2][kNi];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * mi + grp + 8 * h;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int n = n0 + wn + 8 * ni + 2 * quad;
        if (m < M && n < N) in[h][ni] = epi.load(m, n);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * mi + grp + 8 * h;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int n = n0 + wn + 8 * ni + 2 * quad;
        if (m < M && n < N)
          epi.store(m, n, in[h][ni], acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], z);
      }
    }
  }
}

template <typename T, bool A_KC, bool B_KC, typename Epi>
cudaError_t launch_mma_gemm(const T* A, const T* B, int M, int N, int K, int lda, int ldb,
                            int chunk, int splits, const Epi& epi, cudaStream_t stream) {
  const dim3 grid((M + kMmaM - 1) / kMmaM, (N + kMmaN - 1) / kMmaN, splits);
  mma_gemm_kernel<T, A_KC, B_KC, Epi><<<grid, kMmaThreads, 0, stream>>>(A, B, M, N, K, lda, ldb,
                                                                        chunk, epi);
  return cudaGetLastError();
}

}  // namespace cnx
}  // namespace a2m
