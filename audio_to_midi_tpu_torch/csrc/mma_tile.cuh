// The tile primitives of the attention kernels that run on the tensor
// cores: the forward of the global attention (global_attention_fwd.cuh,
// TPU kernels 1, 3, 4 and 15), its backward (global_attention_bwd.cuh, TPU
// kernels 9 and 16) and the backward of the two-phase local attention
// (local_attention_bwd.cuh, TPU kernels 7, 8 and 13, which take the
// products and copies but not the 64-row tile).  One copy, in namespace
// a2m; nothing here launches.
// The tensor-core product (convnext_gemm.cuh: TPU kernel 20 and the fused
// layers, 11, 17, 18) takes its copies, ldmatrix loads and mma from here
// too, but not the 64-row tile: its tiles are its own.  The fused layers'
// global core (fused_layer_impl.cuh) takes the 64-row tile, copy_tile, the
// resident Q, chunk_product and accumulate_product.
//
// What bounds those kernels on this card, and what these pieces do about it.
// At the model's shapes (S = 250, 4 heads x 64) an attention core is a few
// GFLOP over a few tens of MB: far below the tensor cores' 989 TFLOP/s in
// bf16 and, in f32, below the 67 TFLOP/s of the fp32 cores only if the
// products leave them.  Scalar FMA loops over shared memory are bound by the
// shared-memory reads of their operands; so here
//   * the products are warp-level mma.sync: bf16 m16n8k16 with fp32
//     accumulation, operands loaded with ldmatrix (.trans for a tile stored
//     k-major); f32 as 3xTF32 m16n8k8 (each operand split into a tf32 high
//     and low part, hi.hi + hi.lo + lo.hi: ~1e-6 relative, where plain TF32
//     keeps three digits), each k-step's three products in a fresh
//     accumulator added with a rounded FADD, because the tensor core
//     truncates its fp32 sum;
//   * a block of kThreads = 128 threads (4 warps) owns a kTile = 64-row
//     tile, 16 rows per warp: a row's values then sit in one quad of lanes,
//     so a row reduction is two shuffles (quad_max, quad_sum), and an
//     accumulator pair feeds the next product straight from registers as an
//     A fragment (pack_a; in f32 with the depth order permuted to the
//     accumulator's and the B rows loaded to match: load_bt);
//   * tiles stay in shared memory in the working dtype, rows padded by 16
//     bytes (pitch), so ldmatrix (bf16) and the 32-bit fragment loads (f32)
//     are free of bank conflicts;
//   * tiles are copied with 16-byte cp.async (copy_tile), rows at or past S
//     zero-filled, so a kernel can keep the next tile's copy in flight while
//     it computes on this one; round_T(q * scale) is applied by each thread
//     to the pieces it copied (scale_own_pieces), once they land;
//   * the block's resident tile (Resident) is held in registers as A
//     fragments in bf16; f32 reads it from shared memory at each use, since
//     its hi / lo splits would double the registers held (at hd 64 they
//     spilled).

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace a2m {

constexpr int kTile = 64;                // rows of a tile: query rows or key rows
constexpr int kWarps = kTile / 16;       // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;               // columns of the streamed tile per step
constexpr float kMaskFill = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Whether a device buffer may be copied 16 bytes at a time (copy_tile).
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Elements per row of a shared tile: hd plus 16 bytes of padding.
template <typename T, int HD>
__host__ __device__ constexpr int pitch() { return HD + 16 / static_cast<int>(sizeof(T)); }

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes where !inside (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows row0 .. row0 + 63 of one head into a padded shared tile; rows
// at or past S are zero.  Thread i copies the 16-byte pieces i, i + 128, ...
template <typename T, int HD>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, long long base,
                                          long long row_stride, int row0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * kVec;
    const int row = row0 + r;
    const T* from = src + base + static_cast<long long>(row < S ? row : 0) * row_stride + c;
    cp_async16(dst + r * pitch<T, HD>() + c, from, row < S);
  }
}

// round_T(x * scale) in place, over the pieces this thread copied with
// copy_tile: they are visible to it once its cp_wait returns.
template <typename T, int HD>
__device__ __forceinline__ void scale_own_pieces(T* tile, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
    T* x = tile + (i / kPieces) * pitch<T, HD>() + (i % kPieces) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = a2m::from_float<T>(a2m::to_float(x[e]) * scale);
  }
}

// ---------------------------------------------------------------------------
// Warp-level products.  Lane = 4 * grp + quad.  An m16n8 accumulator c[4]
// holds rows grp (c0, c1) and grp + 8 (c2, c3), columns 2 quad and 2 quad + 1.
// Mma<T> gives, for one dtype:
//   kK       the depth of one mma;
//   A, B     the fragment types (A: 16 rows x kK; B: kK x 8 columns);
//   load_a   A of rows m0.. and depth k0.. of a tile stored [row][depth];
//   load_b   B of two n8 tiles (columns n0 .. n0 + 15) at depth k0.. of a
//            tile stored [column][depth];
//   load_bt  the same of a tile stored [depth][column], its depth in the
//            order pack_a gives the accumulator's columns;
//   pack_a   the A fragment of depth step st of a 16 x 16 accumulator pair,
//            rounded to T;
//   mma      d += a . b.
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  using A = uint32_t[4];
  using B = uint32_t[2];

  // ldmatrix x4: lanes 8j .. 8j + 7 give the row addresses of matrix j.
  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld, int m0, int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    ldmatrix_x4(a, tile + (m0 + (lane & 7) + (j & 1) * 8) * ld + k0 + (j >> 1) * 8);
  }
  static __device__ __forceinline__ void load_b(B (&b)[2], const T* tile, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    uint32_t r[4];
    ldmatrix_x4(r, tile + (n0 + (lane & 7) + (j >> 1) * 8) * ld + k0 + (j & 1) * 8);
    b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
  }
  static __device__ __forceinline__ void load_bt(B (&b)[2], const T* tile, int ld, int k0,
                                                 int n0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
    b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
  }
  static __device__ __forceinline__ void pack_a(A& a, const float (&c)[2][4], int) {
    a[0] = pack_bf16(c[0][0], c[0][1]);
    a[1] = pack_bf16(c[0][2], c[0][3]);
    a[2] = pack_bf16(c[1][0], c[1][1]);
    a[3] = pack_bf16(c[1][2], c[1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as a tf32 high part and the tf32 rounding of what it leaves.
__device__ __forceinline__ void split_tf32(uint32_t& hi, uint32_t& lo, float x) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// 3xTF32 on fragments split once (split_tf32) for several products, as the
// ConvNeXt product does: lo.hi + hi.lo + hi.hi, the small terms first, into
// a fresh accumulator that is then added to d rounding to nearest -- the
// arithmetic of Mma<float>::mma.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// f32: the m16n8k8 tf32 fragments hold fp32 values and are split at the
// product.  A: a0 (grp, quad), a1 (grp + 8, quad), a2 (grp, quad + 4),
// a3 (grp + 8, quad + 4); B: b0 (depth quad, column grp), b1 (quad + 4, grp).
// An accumulator holds columns 2 quad and 2 quad + 1, so pack_a takes them
// as depths quad and quad + 4, and load_bt loads depth rows 2 quad and
// 2 quad + 1 to match: the sum over the depth is the same.
template <>
struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  using A = float[4];
  using B = float[2];

  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld, int m0, int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
    const T* p = tile + (m0 + grp) * ld + k0 + quad;
    a[0] = p[0], a[1] = p[8 * ld], a[2] = p[4], a[3] = p[8 * ld + 4];
  }
  static __device__ __forceinline__ void load_b(B (&b)[2], const T* tile, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T* p = tile + (n0 + 8 * j + grp) * ld + k0 + quad;
      b[j][0] = p[0], b[j][1] = p[4];
    }
  }
  static __device__ __forceinline__ void load_bt(B (&b)[2], const T* tile, int ld, int k0,
                                                 int n0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T* p = tile + (k0 + 2 * quad) * ld + n0 + 8 * j + grp;
      b[j][0] = p[0], b[j][1] = p[ld];
    }
  }
  static __device__ __forceinline__ void pack_a(A& a, const float (&c)[2][4], int st) {
    a[0] = c[st][0], a[1] = c[st][2], a[2] = c[st][1], a[3] = c[st][3];
  }
  // 3xTF32: lo.hi + hi.lo + hi.hi, the small terms first, into a fresh
  // accumulator that is then added to d rounding to nearest: the tensor
  // core truncates its fp32 sum, and over the ~100 mma that accumulate one
  // dq output that bias would grow with their count.  The arithmetic of
  // split_tf32 and mma_3xtf32, written out here: expressed through them,
  // one instantiation of the attention forward compiled to other SASS.
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = to_tf32(a[i]);
      al[i] = to_tf32(a[i] - __uint_as_float(ah[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bh[i] = to_tf32(b[i]);
      bl[i] = to_tf32(b[i] - __uint_as_float(bh[i]));
    }
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, al, bh);
    mma_tf32(t, ah, bl);
    mma_tf32(t, ah, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += t[i];
  }
};

// The block's resident tile (Q, G in the dq kernel; K, V in the dkv
// kernel) as the A operand of the warp's 16 rows.  bf16 holds its fragments
// in registers for the whole kernel; f32 reads them from the shared tile at
// each use, since its hi / lo splits would double the registers held.
template <typename T, int HD>
struct Resident;

template <int HD>
struct Resident<__nv_bfloat16, HD> {
  using M = Mma<__nv_bfloat16>;
  typename M::A a[HD / M::kK];
  __device__ __forceinline__ Resident(const __nv_bfloat16* tile, int m0) {
#pragma unroll
    for (int kk = 0; kk < HD / M::kK; ++kk)
      M::load_a(a[kk], tile, pitch<__nv_bfloat16, HD>(), m0, kk * M::kK);
  }
  __device__ __forceinline__ void fetch(typename M::A& out, int kk) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = a[kk][i];
  }
};

template <int HD>
struct Resident<float, HD> {
  using M = Mma<float>;
  const float* tile;
  int m0;
  __device__ __forceinline__ Resident(const float* tile_, int m0_) : tile(tile_), m0(m0_) {}
  __device__ __forceinline__ void fetch(typename M::A& out, int kk) const {
    M::load_a(out, tile, pitch<float, HD>(), m0, kk * M::kK);
  }
};

// s[2][4] = (the warp's 16 resident rows) . (columns n0 .. n0 + 15 of a
// tile stored [column][depth])^T over the head dim.
template <typename T, int HD>
__device__ __forceinline__ void chunk_product(float (&s)[2][4], const Resident<T, HD>& res,
                                              const T* tile, int n0) {
  using M = Mma<T>;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / M::kK; ++kk) {
    typename M::A a;
    res.fetch(a, kk);
    typename M::B b[2];
    M::load_b(b, tile, pitch<T, HD>(), n0, kk * M::kK);
    M::mma(s[0], a, b[0]);
    M::mma(s[1], a, b[1]);
  }
}

// acc[HD / 8][4] += round_T(p) (16 rows x 16 depth rows k0 ..) . (those rows
// of a tile stored [depth][column]).
template <typename T, int HD>
__device__ __forceinline__ void accumulate_product(float (&acc)[HD / 8][4],
                                                   const float (&p)[2][4], const T* tile,
                                                   int k0) {
  using M = Mma<T>;
#pragma unroll
  for (int st = 0; st < kChunk / M::kK; ++st) {
    typename M::A a;
    M::pack_a(a, p, st);
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      typename M::B b[2];
      M::load_bt(b, tile, pitch<T, HD>(), k0 + st * M::kK, nn * 16);
      M::mma(acc[2 * nn], a, b[0]);
      M::mma(acc[2 * nn + 1], a, b[1]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Two outputs (columns d, d + 1) of one row.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float x, float y);

template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

}  // namespace a2m
