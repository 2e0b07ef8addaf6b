// Device code of the fused transformer-layer kernels (TPU kernels 11, 17
// and 18; the family, the roundings and the host routines' contracts:
// fused_layer.cuh): a row LayerNorm, the GLU gate, the products' epilogues,
// the local (window 16, stride 8) and global attention cores with RoPE
// applied as the rows are loaded, and the definitions of Layer<T>.  Included
// by fused_layer_{f32,bf16}.cu only, which compile one dtype each, in
// parallel.
//
// What bounds the family at the default widths (D 256, 4 heads x 64, kv 64,
// FFN 512, P = 256): a pair at 16 windows is ~10.6 GFLOP, ~9.4 of them in its
// 14 products, against ~20 MB of rows through device memory (~6 us at
// 3.35 TB/s): on the tensor cores (989 TFLOP/s bf16) the products alone
// would take ~10 us, so the pair is bound by its launches' latency and
// tails, not by a roofline.  What the design does:
//   * every product on the tensor cores (cnx::mma_gemm_kernel: 128 x 64
//     block tiles, three cp.async stages; bf16 mma.sync m16n8k16, f32 as
//     3xTF32), activations stored along the depth and weights across it,
//     into the epilogues below, which round as the TPU kernels do and take
//     their operands by column pairs;
//   * the global core on the tensor cores as well (global_core_kernel): the
//     two sweeps the rounding of the whole-row softmax needs, over q and k
//     RoPE'd once in the workspace (rope_rows_kernel, rope_rows.cuh), each key tile copied
//     a step ahead;
//   * LayerNorm, the GLU gate and the local core (16 keys per row and
//     window) stay fp32 loops: they move bytes, not operations.

#pragma once

#include <initializer_list>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "convnext_gemm.cuh"
#include "fused_layer.cuh"
#include "mma_tile.cuh"
#include "rope_rows.cuh"

namespace a2m {
namespace fl {

constexpr int kRowWarps = kRowThreads / 32;
constexpr int kCoreThreads = 256;    // the local core's block

// ---------------------------------------------------------------------------
// Epilogues of the products (see cnx::mma_gemm_kernel): out(m, n), out(m,
// n + 1) from the fp32 sums acc0, acc1.  ELEMS: the operands' rows do not
// all start on 16 bytes, so the tiles are copied element by element
// (kElementCopies) and the epilogue reads and writes element by element,
// the second column only where n + 1 < N (an odd width).  The out, x and
// bias rows hold N = ld values.
// ---------------------------------------------------------------------------

using cnx::get2;
using cnx::put2;

template <typename T, bool ELEMS>
struct StoreEpi {  // out = round(acc)
  static constexpr bool kElementCopies = ELEMS;
  T* out;
  int ld;
  struct In {};
  __device__ __forceinline__ In load(int, int) const { return {}; }
  __device__ __forceinline__ void store(int m, int n, In, float acc0, float acc1, int) const {
    put2<ELEMS>(out + static_cast<size_t>(m) * ld + n, acc0, acc1, n + 1 < ld);
  }
};

template <typename T, bool ELEMS>
struct BiasEpi {  // out = round(acc + b)
  static constexpr bool kElementCopies = ELEMS;
  const T* bias;
  T* out;
  int ld;
  using In = float2;
  __device__ __forceinline__ In load(int, int n) const {
    return get2<ELEMS>(bias + n, n + 1 < ld);
  }
  __device__ __forceinline__ void store(int m, int n, In b, float acc0, float acc1, int) const {
    put2<ELEMS>(out + static_cast<size_t>(m) * ld + n, acc0 + b.x, acc1 + b.y, n + 1 < ld);
  }
};

// out = x + round(acc [+ b]) on the rows [lo, hi) of each sample of P rows,
// out = x on the others (their branch is masked to zero).  The sum is in
// the dtype: round(x + round(branch)).
template <typename T, bool ELEMS>
struct ResidualEpi {
  static constexpr bool kElementCopies = ELEMS;
  const T* x;
  const T* bias;  // may be null
  T* out;
  int ld, P, lo, hi;
  struct In {
    float2 x, b;
  };
  __device__ __forceinline__ In load(int m, int n) const {
    const bool second = n + 1 < ld;
    return {get2<ELEMS>(x + static_cast<size_t>(m) * ld + n, second),
            bias != nullptr ? get2<ELEMS>(bias + n, second) : make_float2(0.f, 0.f)};
  }
  __device__ __forceinline__ void store(int m, int n, const In& in, float acc0, float acc1,
                                        int) const {
    T* at = out + static_cast<size_t>(m) * ld + n;
    const int p = m % P;
    if (p < lo || p >= hi) {
      put2<ELEMS>(at, in.x.x, in.x.y, n + 1 < ld);
      return;
    }
    const float b0 = round_to<T>(bias != nullptr ? acc0 + in.b.x : acc0);
    const float b1 = round_to<T>(bias != nullptr ? acc1 + in.b.y : acc1);
    put2<ELEMS>(at, in.x.x + b0, in.x.y + b1, n + 1 < ld);
  }
};

// The product a (R, K) . w (K, N) into the epilogue Epi<T, ELEMS>{fields...}
// on the tensor cores, activations stored along the depth and weights
// across it.  `touched`: the other buffers the epilogue reads or writes,
// rows of N values.  The tiles are copied 16 bytes at a time where every
// buffer starts on 16 bytes and K and N values fill whole 16-byte pieces,
// element by element (ELEMS) otherwise.
template <template <typename, bool> class Epi, typename T, typename... Fields>
cudaError_t product(const T* a, const T* w, int R, int N, int K,
                    std::initializer_list<const void*> touched, cudaStream_t stream,
                    Fields... fields) {
  bool aligned = aligned16(a) && aligned16(w) && static_cast<size_t>(K) * sizeof(T) % 16 == 0 &&
                 static_cast<size_t>(N) * sizeof(T) % 16 == 0;
  for (const void* p : touched) aligned = aligned && aligned16(p);
  if (aligned)
    return cnx::launch_mma_gemm<T, true, false>(a, w, R, N, K, K, N, K, 1,
                                                Epi<T, false>{fields...}, stream);
  return cnx::launch_mma_gemm<T, true, false>(a, w, R, N, K, K, N, K, 1, Epi<T, true>{fields...},
                                              stream);
}

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------

// out = LayerNorm(x) * scale + bias, cast to T; ln: (2, D) fp32.  With
// `masked`, rows outside [lo, hi) of each sample of P rows are zero.  One
// warp per row.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln, T* __restrict__ out, int R,
               int D, int P, int lo, int hi, bool masked) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  if (r >= R) return;
  const T* row = x + r * D;
  T* dst = out + r * D;
  const int p = static_cast<int>(r % P);
  if (masked && (p < lo || p >= hi)) {
    for (int c = lane; c < D; c += 32) dst[c] = from_float<T>(0.f);
    return;
  }
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += to_float(row[c]);
  const float mean = cnx::warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float cent = to_float(row[c]) - mean;
    sq += cent * cent;
  }
  const float var = cnx::warp_sum(sq) / static_cast<float>(D);
  const float rstd = 1.0f / sqrtf(var + cnx::kLnEps);
  for (int c = lane; c < D; c += 32) {
    const float y = __fmul_rn(to_float(row[c]) - mean, rstd);
    dst[c] = from_float<T>(__fadd_rn(__fmul_rn(y, ln[c]), ln[D + c]));
  }
}

// The GLU gate of the FFN: g = round(round(gelu(a)) * b) with a, b the two
// halves of a row of h1 (R, 2I); g: (R, I).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
glu_kernel(const T* __restrict__ h1, T* __restrict__ g, long long total, int inter) {
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= total) return;
  const long long r = i / inter;
  const int c = static_cast<int>(i % inter);
  const float a = to_float(h1[r * 2 * inter + c]);
  const float b = to_float(h1[r * 2 * inter + inter + c]);
  const float gelu = round_to<T>(cnx::gelu_from_tanh(a, cnx::gelu_tanh_term(a)));
  g[i] = from_float<T>(gelu * b);
}

// ---------------------------------------------------------------------------
// The local core: windows of 16 rows at stride 8 over P rows (P a multiple
// of 8), attention inside each window with RoPE positions restarting in
// every window, the overlap average.
// ---------------------------------------------------------------------------
//
// Window w covers rows [8w, 8w + 16), w in [0, P/8 - 1).  Row r of block
// k = r / 8 lies in window k (first half, position r - 8k) and window k - 1
// (second half, position r - 8k + 8), where they exist.  For P % 16 == 0
// the even windows are the TPU kernels' phase A and the odd ones phase B;
// the blocks at the two ends have one window and take its output alone,
// the others average the two: round((a + b) * 0.5), a and b each the
// window's output rounded to T.  (Kernel 11 adds in the dtype and divides
// by the count in fp32, the same number, since halving is exact.)  The
// table row of each (window, row) is chosen by TableMode (fused_layer.cuh).

// One block per (8-row block k, head, sample): 256 threads, thread
// (row i = t / 32, window half u = t / 16 % 2, key j = t % 16) -- u = 0 is
// window k, u = 1 window k - 1 -- so a (row, window) softmax reduces over 16
// lanes and a row's two windows meet in one warp.  The output row r goes to
// out row r + shift when r < limit (kernels 17 and 18 re-store the first S
// rows at offset pad_l; kernel 11 keeps all P).  What bounds it: memory --
// per (row, window) 16 keys, two products of 16 x hd.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kCoreThreads)
local_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ cos_a, const float* __restrict__ sin_a,
                  const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                  T* __restrict__ out, int P, int H, int shift, int limit, float scale) {
  constexpr int kHalf = HD / 2;
  __shared__ float sQ[2][kStride][HD + 1];   // [window half][row][d], rope'd and scaled
  __shared__ float sK[2][kWindow][HD + 1];   // [window half][key][d], rope'd
  __shared__ float sV[kWindow + kStride][HD];  // rows 8k - 8 .. 8k + 15
  __shared__ float sW[2][kStride][kWindow + 1];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x, head = blockIdx.y, sample = blockIdx.z;
  const int nb = P / kStride;
  const int W = H * HD;
  const long long base = static_cast<long long>(sample) * P;
  const int r0 = blk * kStride;

  // Window of a half and its first row; whether it exists.
  auto window_of = [&](int u) { return blk - u; };
  auto exists = [&](int u) {
    const int w = blk - u;
    return w >= 0 && w <= nb - 2;
  };
  auto table_row = [&](int u, int r, int pos, const float*& c, const float*& s) {
    const int w = window_of(u);
    if (MODE == kTablesByWindow) {
      c = cos_a + static_cast<size_t>(kWindow * w + pos) * kHalf;
      s = sin_a + static_cast<size_t>(kWindow * w + pos) * kHalf;
    } else {
      const bool even = (w & 1) == 0;
      c = (even ? cos_a : cos_b) + static_cast<size_t>(r) * kHalf;
      s = (even ? sin_a : sin_b) + static_cast<size_t>(r) * kHalf;
    }
  };

  for (int i = tid; i < 2 * kStride * HD; i += kCoreThreads) {
    const int u = i / (kStride * HD), rr = (i / HD) % kStride, d = i % HD;
    float val = 0.f;
    if (exists(u)) {
      const int r = r0 + rr;
      const int pos = u == 0 ? rr : rr + kStride;
      const float *c, *s;
      table_row(u, r, pos, c, s);
      const float rot = rope_elem<T>(q + (base + r) * W + head * HD, d, HD, c, s);
      val = scaled_in_dtype(from_float<T>(rot), scale);
    }
    sQ[u][rr][d] = val;
  }
  for (int i = tid; i < 2 * kWindow * HD; i += kCoreThreads) {
    const int u = i / (kWindow * HD), j = (i / HD) % kWindow, d = i % HD;
    float val = 0.f;
    if (exists(u)) {
      const int first = kStride * window_of(u);
      const int r = first + j;
      const float *c, *s;
      table_row(u, r, j, c, s);
      val = rope_elem<T>(k + (base + r) * W + head * HD, d, HD, c, s);
    }
    sK[u][j][d] = val;
  }
  for (int i = tid; i < (kWindow + kStride) * HD; i += kCoreThreads) {
    const int rr = i / HD, d = i % HD;
    const int r = r0 - kStride + rr;
    sV[rr][d] = r >= 0 && r < P ? to_float(v[(base + r) * W + head * HD + d]) : 0.f;
  }
  __syncthreads();

  const int row = tid >> 5;         // 0..7
  const int u = (tid >> 4) & 1;     // 0: window k, 1: window k - 1
  const int j = tid & 15;
  float logit = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) logit = fmaf(sQ[u][row][d], sK[u][j][d], logit);
  float m = logit;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = expf(logit - m);
  float l = e;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  sW[u][row][j] = round_to<T>(e / l);
  __syncwarp();

  // sV row of key c of window half u: window k starts at 8k (sV row 8),
  // window k - 1 at 8k - 8 (sV row 0).
  const int v_first = u == 0 ? kStride : 0;
  const bool have_a = exists(0), have_b = exists(1);
  const int r = r0 + row;
#pragma unroll
  for (int e2 = 0; e2 < HD / kWindow; ++e2) {
    const int d = j + kWindow * e2;
    float o = 0.f;
#pragma unroll
    for (int c = 0; c < kWindow; ++c) o = fmaf(sW[u][row][c], sV[v_first + c][d], o);
    const float mine = round_to<T>(o);
    const float other = __shfl_down_sync(0xffffffffu, mine, 16);  // lane j + 16: window k - 1
    if (u == 0 && r < limit) {
      float avg;
      if (have_a && have_b) avg = (mine + other) * 0.5f;
      else avg = have_a ? mine : other;
      out[(base + r + shift) * W + head * HD + d] = from_float<T>(avg);
    }
  }
}

// ---------------------------------------------------------------------------
// The global core: every row of a sample attends to the columns in [lo, hi)
// of its P rows; other columns below P take the -1e30 fill, columns at or
// past P (a ragged last tile) -inf.  RoPE from one table row per sequence
// row.
// ---------------------------------------------------------------------------

// One block of 4 warps per (64 query rows, head, sample), 16 rows per warp,
// on mma_tile.cuh's primitives, over q and k RoPE'd (and q scaled) by
// rope_rows_kernel.  The weights are cast to T only after the row's final
// max and sum (the TPU's whole-row softmax, then the cast), so the n key
// tiles are walked twice, as one loop of 2 n steps:
//   1. steps 0 .. n - 1: the logits of a 64-column tile (mma.sync: bf16
//      m16n8k16, f32 as 3xTF32), masked in their fp32 accumulators, fold
//      into each row's online max (quad-uniform) and each lane's share of
//      the row sum, a tile at a time in bf16 and 16 columns at a time in
//      f32;
//   2. steps n .. 2 n - 1: the logits again, the weights round_T(exp(s - m)
//      / l) packed from the accumulators straight into the A fragments of
//      O += P . V, 16 columns at a time; out = round_T(O).
// Q is copied once and held as A fragments (bf16) or read from shared
// memory (f32).  Each step's K tile (and in the second sweep its V tile)
// comes by 16-byte cp.async one step ahead, into the other of two stages,
// so its copy overlaps this step's products: one barrier per step.  The key
// tiles walked are those that hold a column in [lo, hi): every row sees a
// column there, so the tiles outside add exp(-1e30 - m) = 0 and skipping
// them is exact.  What bounds it: at 16 windows of P = 256, 4 heads x 64,
// its 1.6 GFLOP (the logits twice) take ~2 us on the tensor cores and its 8
// MB ~2.5 us; with 2 n dependent steps per block it is bound by latency.
// No atomics.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && HD <= 64 ? 4 : 2)
global_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, int P, int H, int lo, int hi) {
  constexpr int kElems = kTile * pitch<T, HD>();
  constexpr int kChunks = kTile / kChunk;
  // Chunks per fold of the online statistics: a whole tile in bf16; one in
  // f32, whose 3xTF32 splits left a whole tile's logits spilling at hd 64.
  constexpr int kGroup = sizeof(T) == 2 ? kChunks : 1;
  extern __shared__ __align__(16) unsigned char smem_core[];
  T* sQ = reinterpret_cast<T*>(smem_core);
  T* sK = sQ + kElems;      // stage s at sK + s * kElems
  T* sV = sK + 2 * kElems;

  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int q0 = blockIdx.x * kTile;
  const int rows[2] = {q0 + m0 + (lane >> 2), q0 + m0 + (lane >> 2) + 8};
  const bool live = q0 + m0 < P;           // the warp has a row below P
  const long long W = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(blockIdx.z) * P * W +
                         static_cast<long long>(blockIdx.y) * HD;
  const int first = lo / kTile, n = (hi - 1) / kTile - first + 1;

  copy_tile<T, HD>(sQ, q, base, W, q0, P);
  copy_tile<T, HD>(sK, k, base, W, first * kTile, P);  // step 0
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const Resident<T, HD> rq(sQ, m0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, sum[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int i = 0; i < 2 * n; ++i) {
    const int k0 = (first + i % n) * kTile;
    const T* tK = sK + (i & 1) * kElems;
    const T* tV = sV + (i & 1) * kElems;
    cp_wait<0>();     // this thread's copies of step i have landed ...
    __syncthreads();  // ... and every thread's; step i - 1 is done with the other stage
    if (i + 1 < 2 * n) {  // step i + 1's tiles into the other stage
      const int next = (first + (i + 1) % n) * kTile;
      copy_tile<T, HD>(sK + ((i + 1) & 1) * kElems, k, base, W, next, P);
      if (i + 1 >= n) copy_tile<T, HD>(sV + ((i + 1) & 1) * kElems, v, base, W, next, P);
      cp_commit();
    }
    if (!live) continue;  // warp-uniform

    // The masked logits of columns k0 + 16 c .. + 15 against the warp's rows.
    auto chunk_logits = [&](float (&s)[2][4], int c) {
      chunk_product<T, HD>(s, rq, tK, c * kChunk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c * kChunk + 8 * j + 2 * quad + (e & 1);
          if (col < lo || col >= hi) s[j][e] = col < P ? kMaskFill : -INFINITY;
        }
    };
    if (i < n) {  // sweep 1: the row max and this lane's share of the sum
#pragma unroll
      for (int c0 = 0; c0 < kChunks; c0 += kGroup) {
        float s[kGroup][2][4];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) chunk_logits(s[c], c0 + c);
        float group_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              group_max[e >> 1] = fmaxf(group_max[e >> 1], s[c][j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(group_max[r]));
          l[r] *= expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[c][j][e] - m[e >> 1]);
      }
      continue;
    }
    if (i == n) sum[0] = quad_sum(l[0]), sum[1] = quad_sum(l[1]);
    // Sweep 2: the weights, normalized and rounded to T, times v.
    auto chunk_weights = [&](int c) {
      float s[2][4];
      chunk_logits(s, c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / sum[e >> 1];
      accumulate_product<T, HD>(acc, s, tV, c * kChunk);  // rounds the weights to T
    };
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) chunk_weights(c);
    } else {  // f32: one chunk's 3xTF32 splits live at a time
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c) chunk_weights(c);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= P) continue;
    T* dst = out + base + rows[r] * W + 2 * quad;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) store_pair<T>(dst + 8 * d, acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_ln(const T* x, const float* ln, T* out, const Geometry& g, int lo, int hi,
                      bool masked, cudaStream_t stream) {
  const long long R = g.rows();
  ln_rows_kernel<T><<<static_cast<unsigned>((R + kRowWarps - 1) / kRowWarps), kRowThreads, 0,
                      stream>>>(x, ln, out, static_cast<int>(R), g.D, g.P, lo, hi, masked);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_local_hd(const AttnBuffers<T>& b, const float* const* tables, int mode,
                            const Geometry& g, int shift, int limit, float scale,
                            cudaStream_t stream) {
  const dim3 grid(g.P / kStride, g.H, g.B);
  if (mode == kTablesByWindow)
    local_core_kernel<T, HD, kTablesByWindow><<<grid, kCoreThreads, 0, stream>>>(
        b.q, b.k, b.v, tables[0], tables[1], tables[0], tables[1], b.attn, g.P, g.H, shift,
        limit, scale);
  else
    local_core_kernel<T, HD, kTablesByRow><<<grid, kCoreThreads, 0, stream>>>(
        b.q, b.k, b.v, tables[0], tables[1], tables[2], tables[3], b.attn, g.P, g.H, shift,
        limit, scale);
  return cudaGetLastError();
}

// RoPE on q and k in the workspace (rope_rows_kernel), then the core.
template <typename T, int HD>
cudaError_t launch_global_hd(const AttnBuffers<T>& b, const float* cos_t, const float* sin_t,
                             const Geometry& g, int lo, int hi, float scale,
                             cudaStream_t stream) {
  const long long items = g.rows() * g.H * (HD / 2 / Piece<T>::kVec);
  rope_rows_kernel<T, HD><<<static_cast<unsigned>((items + kRowThreads - 1) / kRowThreads),
                            kRowThreads, 0, stream>>>(b.q, b.k, cos_t, sin_t, items, g.P, g.H,
                                                      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(T) * 5 * kTile * pitch<T, HD>();  // Q; two stages of K, V
  err = cudaFuncSetAttribute(global_core_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.P + kTile - 1) / kTile, g.H, g.B);
  global_core_kernel<T, HD><<<grid, kThreads, smem, stream>>>(b.q, b.k, b.v, b.attn, g.P, g.H, lo,
                                                              hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t Layer<T>::projections(const T* a, const T* wq, const T* wkv, const T* wk,
                                  const T* wv, const AttnBuffers<T>& b, const Geometry& g,
                                  cudaStream_t stream) {
  const int R = static_cast<int>(g.rows()), W = g.width();
  cudaError_t err = product<StoreEpi>(a, wq, R, W, g.D, {b.q}, stream, b.q, W);
  if (err != cudaSuccess) return err;
  err = product<StoreEpi>(a, wkv, R, g.C, g.D, {b.ckv}, stream, b.ckv, g.C);
  if (err != cudaSuccess) return err;
  err = product<StoreEpi>(b.ckv, wk, R, W, g.C, {b.k}, stream, b.k, W);
  if (err != cudaSuccess) return err;
  return product<StoreEpi>(b.ckv, wv, R, W, g.C, {b.v}, stream, b.v, W);
}

template <typename T>
cudaError_t Layer<T>::local_core(const AttnBuffers<T>& b, const float* const* tables, int mode,
                                 const Geometry& g, int shift, int limit, float scale,
                                 cudaStream_t stream) {
  switch (g.hd) {
    case 16: return launch_local_hd<T, 16>(b, tables, mode, g, shift, limit, scale, stream);
    case 32: return launch_local_hd<T, 32>(b, tables, mode, g, shift, limit, scale, stream);
    case 64: return launch_local_hd<T, 64>(b, tables, mode, g, shift, limit, scale, stream);
    case 128: return launch_local_hd<T, 128>(b, tables, mode, g, shift, limit, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t Layer<T>::global_core(const AttnBuffers<T>& b, const float* cos_t,
                                  const float* sin_t, const Geometry& g, int lo, int hi,
                                  float scale, cudaStream_t stream) {
  switch (g.hd) {
    case 16: return launch_global_hd<T, 16>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 32: return launch_global_hd<T, 32>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 64: return launch_global_hd<T, 64>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 128: return launch_global_hd<T, 128>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t Layer<T>::out_projection(const T* attn, const T* wo, T* out, const Geometry& g,
                                     cudaStream_t stream) {
  return product<StoreEpi>(attn, wo, static_cast<int>(g.rows()), g.D, g.width(), {out}, stream,
                           out, g.D);
}

template <typename T>
cudaError_t Layer<T>::attention_sublayer(const T* x, const float* ln, const T* wq, const T* wkv,
                                         const T* wk, const T* wv, const T* wo,
                                         const float* const* tables, T* out,
                                         const AttnBuffers<T>& b, const Geometry& g, int S,
                                         int pad_l, bool local, float scale,
                                         cudaStream_t stream) {
  const int lo = pad_l, hi = pad_l + S;
  cudaError_t err = launch_ln<T>(x, ln, b.normed, g, lo, hi, true, stream);
  if (err != cudaSuccess) return err;
  err = projections(b.normed, wq, wkv, wk, wv, b, g, stream);
  if (err != cudaSuccess) return err;
  // The local branch's quirk: the first S rows of the average go to rows
  // pad_l + i; the residual epilogue masks the rest.
  err = local ? local_core(b, tables, kTablesByRow, g, pad_l, S, scale, stream)
              : global_core(b, tables[0], tables[1], g, lo, hi, scale, stream);
  if (err != cudaSuccess) return err;
  return product<ResidualEpi>(b.attn, wo, static_cast<int>(g.rows()), g.D, g.width(), {x, out},
                              stream, x, static_cast<const T*>(nullptr), out, g.D, g.P, lo, hi);
}

template <typename T>
cudaError_t Layer<T>::ffn_sublayer(const T* x, const float* ln, const T* w1, const T* b1,
                                   const T* w2, const T* b2, T* out, T* normed, T* h1, T* gate,
                                   const Geometry& g, int S, int pad_l, cudaStream_t stream) {
  const int R = static_cast<int>(g.rows());
  cudaError_t err = launch_ln<T>(x, ln, normed, g, 0, g.P, false, stream);
  if (err != cudaSuccess) return err;
  err = product<BiasEpi>(normed, w1, R, 2 * g.I, g.D, {b1, h1}, stream, b1, h1, 2 * g.I);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(R) * g.I;
  glu_kernel<T><<<static_cast<unsigned>((total + kRowThreads - 1) / kRowThreads), kRowThreads, 0,
                  stream>>>(h1, gate, total, g.I);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return product<ResidualEpi>(gate, w2, R, g.D, g.I, {x, b2, out}, stream, x, b2, out, g.D, g.P,
                              pad_l, pad_l + S);
}

}  // namespace fl
}  // namespace a2m
