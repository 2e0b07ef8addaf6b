// Backward of the two-phase local (sliding-window) attention: dqa, dka, dqb,
// dkb and dv from the five inputs and the cotangent g of the overlap-averaged
// output, window 16, stride 8, in padded coordinates.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py two_phase_grads (:992,
// _two_phase_bwd_kernel), two_phase_grads_drop (:1025, precomputed uint8
// bits (B, H, P, P) per phase) and two_phase_grads_drop_prng (:1682, bytes
// drawn from the forward's seed), all of them _two_phase_bwd_core ->
// _core_grads, :880-968.  The mask source is a template parameter of the one
// body; a kept weight w and its dw are scaled by 256 / (256 - threshold),
// dropped ones are 0, delta sums dw * w over the undropped w.  The TPU
// kernel recomputes two P x P masked logit matrices per (sample, head)
// because its matrix unit wants large tiles.  Here every row has 16 keys per
// phase, so a core is one 16 x 16 window:
//   g' = g * (0.5 inside [8, P-8), 1 at the edges), exact in T;
//   w = softmax(round_T(q * scale) . k^T) over the window's 16 keys;
//   dv = round_T(w_used)^T . g';   dw = g' . v^T (dropped as w);
//   dlogits = round_T(w * (dw - sum_c dw w));
//   dq = (dlogits . k) * scale;   dk = dlogits^T . round_T(q * scale).
// Phase A uses windows 16w..16w+15; phase B windows 16u+8..16u+23 (u = 0 ..
// P/16-2), which hold only rows of [8, P-8) -- the rows outside have no
// phase B, which is what the TPU kernel's zeroed g and in_band column mask
// come to.  dv = round_T(dv_a + dv_b), summed in fp32.
//
// What bounds it on the card.  It reads 6 and writes 5 tensors of B x P x
// H*hd once -- at the training shapes (32, 256, 256) 46 MB in bf16 (0.0138 ms
// at 3.35 TB/s) and 92 MB in f32 (0.0275 ms) -- against 0.67 GFLOP of useful
// products: bytes, by far.  The scalar body this replaces (a lane per (row,
// key) pair, its products walking the head dim over shared memory) was bound
// by the shared-memory pipe instead: ~12 K wavefronts per 16 rows, ~0.11 ms
// in f32 and bf16 alike.  This body runs at ~2.4x (bf16) and ~2.7x (f32) of
// the bound on an H100: a block copies, computes, then stores, so the
// card's reads and writes meet only across blocks, and the 512 blocks of
// the training shapes fit 3 (bf16) or 1 (f32) to an SM.  Blocks that walk
// several row chunks with the next chunk's copies in flight were no faster
// in bf16 and slower in f32: two stages leave room for one block of 5 (or
// 3) warps per SM, too few to hide the products' latency.
//
// The design.
//   * A block of NA + 1 warps owns the rows r0 .. r0 + 16 NA - 1 (NA =
//     kBlockWindows phase-A windows, 4) of one (sample, head).  Warp w
//     computes the phase-B window that starts at r0 - 8 + 16 w and, for w <
//     NA, the phase-A window that starts at r0 + 16 w: the NA + 1 phase-B
//     windows that touch the block's rows, the edge ones half used.  Phase B
//     is recomputed (NA + 1) / NA times, with no atomics and no scratch in
//     device memory, so a call repeats bit for bit.
//   * The rows are copied once with 16-byte cp.async: r0 .. of qa and ka, r0
//     - 8 .. of qb, kb, v and g (16 NA + 16 rows), zero outside [0, P); the
//     copying thread scales its pieces of q in T and halves its band rows of
//     g.  The mask bytes: Philox drawn into shared memory by the threads,
//     bits by 8-byte cp.async.
//   * A window core runs on the tensor cores (mma_tile.cuh): bf16 mma.sync
//     m16n8k16 with fp32 accumulation, f32 as 3xTF32 m16n8k8.  S = Q K^T
//     and dW = G' V^T are 16 x 16 accumulator pairs; the softmax, the mask,
//     delta and the roundings are done on the fragments (a row's 16 values
//     sit in one quad of lanes); dQ = dL K takes dL straight from the
//     registers as its A operand; dK = dL^T Q and dV = W_used^T G' take it
//     transposed from a per-warp 16 x 16 tile in T (ldmatrix .trans in bf16).
//     The three products run one after another, each stored as it ends.
//   * dq and dk leave from the fragments as bf16x2 / float2 stores, each
//     warp its rows inside the block.  dv_a and dv_b go to shared memory in
//     fp32, over the warp's own q / k rows, which no one reads any more;
//     after one barrier each row's two halves are added (fp32 addition of
//     two terms: the order cannot matter), rounded once and stored 16 bytes
//     at a time.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "local_window.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace a2m {

// The launch arguments, as the C entry receives them.
struct LocalGradsArgs {
  const void *qa, *ka, *qb, *kb, *v, *g, *bits_a, *bits_b, *seed;
  void *dqa, *dka, *dqb, *dkb, *dv;
  int B, P, H, threshold;
  float scale;
  cudaStream_t stream;
};

// The launches of one dtype, in local_attention_bwd_{f32,bf16}.cu: the
// instantiations of each dtype compile in parallel.
cudaError_t local_two_phase_grads_f32(const LocalGradsArgs& a, int hd);
cudaError_t local_two_phase_grads_bf16(const LocalGradsArgs& a, int hd);

}  // namespace a2m

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh)

// Phase-A windows per block (NA below): 64 rows.  Blocks of 32 rows
// measured the same on the H100, in bf16 and f32.
constexpr int kBlockWindows = 4;

// Where everything of a block lies in its dynamic shared memory, in elements
// of T from the start (the mask bytes: in bytes).
template <typename T, int HD, int MASK>
struct Layout {
  static constexpr int NA = kBlockWindows;
  static constexpr int kWarps = NA + 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsA = kWin * NA;        // the block's rows
  static constexpr int kRowsB = kRowsA + kWin;    // its phase-B windows' rows
  static constexpr int kLd = pitch<T, HD>();      // a row of a q, k, v or g tile
  static constexpr int kTp = pitch<T, kWin>();    // a row of a 16 x 16 tile
  static constexpr int kSp = HD + 8;              // a row of a staged dv, floats
  // One window: its 16 q rows, then its 16 k rows.
  static constexpr int kWindow = 2 * kWin * kLd;
  static constexpr int kA = 0;                        // NA phase-A windows
  static constexpr int kB = kA + NA * kWindow;        // NA + 1 phase-B windows
  static constexpr int kV = kB + kWarps * kWindow;    // kRowsB rows
  static constexpr int kG = kV + kRowsB * kLd;        // kRowsB rows of g'
  static constexpr int kT = kG + kRowsB * kLd;        // a 16 x 16 tile per warp
  static constexpr int kMask = (kT + kWarps * kWin * kTp) * static_cast<int>(sizeof(T));
  // Mask bytes, 16 per row: the kRowsA phase-A rows, then the kRowsB phase-B rows.
  static constexpr size_t kBytes =
      kMask + (MASK == kMaskNone ? 0 : (kRowsA + kRowsB) * kWin);
  static_assert(kWin * kSp * sizeof(float) <= kWindow * sizeof(T),
                "a window's dv fits over its q and k rows");
  static_assert(kMask % 16 == 0 && kLd * sizeof(T) % 16 == 0 && kTp * sizeof(T) % 16 == 0,
                "aligned rows");
};

// The A fragment of depth step st of the transpose of a 16 x 16 tile stored
// [depth][row] (pitch kTp): in bf16 by ldmatrix .trans; in f32 with the
// depth order of Mma<float>::load_bt (depths 2 quad, 2 quad + 1 of the step
// as its quad, quad + 4), so that it pairs with B rows loaded by load_bt.
template <typename T>
__device__ __forceinline__ void load_a_trans(typename Mma<T>::A& a, const T* tile, int st);

template <>
__device__ __forceinline__ void load_a_trans<__nv_bfloat16>(Mma<__nv_bfloat16>::A& a,
                                                            const __nv_bfloat16* tile, int) {
  constexpr int kTp = pitch<__nv_bfloat16, kWin>();
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldmatrix_x4_trans(a, tile + ((j >> 1) * 8 + (lane & 7)) * kTp + (j & 1) * 8);
}

template <>
__device__ __forceinline__ void load_a_trans<float>(Mma<float>::A& a, const float* tile,
                                                    int st) {
  constexpr int kTp = pitch<float, kWin>();
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  const float* p = tile + (8 * st + 2 * quad) * kTp + grp;
  a[0] = p[0], a[1] = p[8], a[2] = p[kTp], a[3] = p[kTp + 8];
}

// acc = round_T(p)^T . b: p a 16 x 16 accumulator pair (rows = depth of the
// product), b 16 rows of a tile stored [depth][column] (pitch<T, HD>).  p
// goes through the warp's 16 x 16 tile.
template <typename T, int HD>
__device__ __forceinline__ void transposed_product(float (&acc)[HD / 8][4],
                                                   const float (&p)[2][4], T* tile,
                                                   const T* b_tile) {
  using M = Mma<T>;
  constexpr int kTp = pitch<T, kWin>();
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  __syncwarp();  // the tile's last reader is done
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store_pair<T>(tile + (grp + 8 * r) * kTp + 8 * j + 2 * quad, p[j][2 * r], p[j][2 * r + 1]);
  __syncwarp();
  zero<HD>(acc);
#pragma unroll
  for (int st = 0; st < kWin / M::kK; ++st) {
    typename M::A a;
    load_a_trans<T>(a, tile, st);
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      typename M::B b[2];
      M::load_bt(b, b_tile, pitch<T, HD>(), st * M::kK, nn * 16);
      M::mma(acc[2 * nn], a, b[0]);
      M::mma(acc[2 * nn + 1], a, b[1]);
    }
  }
}

// The weights of one window core on the warp's fragments: wu = w_used and
// dl = w * (dw - sum_c dw w), both still in fp32 (rounded to T where they
// enter a product).  q (scaled), k, v, g' (g): the window's 16 rows, pitch
// pitch<T, HD>; mask: its 16 x 16 bytes.
template <typename T, int HD, int MASK>
__device__ __forceinline__ void window_weights(float (&wu)[2][4], float (&dl)[2][4],
                                               const T* q, const T* k, const T* v, const T* g,
                                               const uint8_t* mask, int threshold,
                                               float keep_inv) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  float s[2][4], dw[2][4];
  {
    const Resident<T, HD> rq(q, 0);
    chunk_product<T, HD>(s, rq, k, 0);
  }
  {
    const Resident<T, HD> rg(g, 0);
    chunk_product<T, HD>(dw, rg, v, 0);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows grp and grp + 8
    const float m = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                   fmaxf(s[1][2 * r], s[1][2 * r + 1])));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = expf(s[j][e] - m);
        l += s[j][e];
      }
    l = quad_sum(l);
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float w = s[j][e] / l;
        s[j][e] = w;
        wu[j][e] = w;
        if (MASK != kMaskNone) {
          const int byte = mask[(grp + 8 * r) * kWin + 8 * j + 2 * quad + (e & 1)];
          wu[j][e] = apply_mask_byte(w, byte, threshold, keep_inv);
          dw[j][e] = apply_mask_byte(dw[j][e], byte, threshold, keep_inv);
        }
        delta = fmaf(dw[j][e], w, delta);
      }
    delta = quad_sum(delta);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) dl[j][e] = s[j][e] * (dw[j][e] - delta);
  }
}

// The warp's rows row0 + grp, row0 + grp + 8 of acc * mul into out, those in
// [lo, hi) only.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long base,
                                           long long row_stride, int row0, int lo, int hi,
                                           const float (&acc)[HD / 8][4], float mul) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + grp + 8 * r;
    if (row < lo || row >= hi) continue;
    T* p = out + base + static_cast<long long>(row) * row_stride + 2 * quad;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair<T>(p + 8 * n, acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

// acc into a staged dv (fp32, pitch kSp) over the window's q and k rows.
template <int HD, int SP>
__device__ __forceinline__ void stage_rows(float* stage, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  __syncwarp();  // every lane is done with the window's q and k rows
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(stage + (grp + 8 * r) * SP + 8 * n + 2 * quad) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

// One window core of the warp: dq into dq_out and dk into dk_out (rows
// [lo, hi) of them), dv staged over the window's q and k rows.  A window
// that does not exist gives zeros.
template <typename T, int HD, int MASK>
__device__ __forceinline__ void window_core(bool exists, T* window, const T* v, const T* g,
                                            const uint8_t* mask, T* tile, T* __restrict__ dq_out,
                                            T* __restrict__ dk_out, long long base,
                                            long long row_stride, int row0, int lo, int hi,
                                            int threshold, float keep_inv, float scale) {
  using L = Layout<T, HD, MASK>;
  const T* q = window;
  const T* k = window + kWin * L::kLd;
  float wu[2][4], dl[2][4];
  float acc[HD / 8][4];
  if (exists) window_weights<T, HD, MASK>(wu, dl, q, k, v, g, mask, threshold, keep_inv);
  zero<HD>(acc);
  if (exists) accumulate_product<T, HD>(acc, dl, k, 0);
  store_rows<T, HD>(dq_out, base, row_stride, row0, lo, hi, acc, scale);
  if (exists) transposed_product<T, HD>(acc, dl, tile, q);
  store_rows<T, HD>(dk_out, base, row_stride, row0, lo, hi, acc, 1.f);
  if (exists) transposed_product<T, HD>(acc, wu, tile, g);
  stage_rows<HD, L::kSp>(reinterpret_cast<float*>(window), acc);
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(Layout<T, HD, MASK>::kThreads)
local_two_phase_grads_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                             const T* __restrict__ qb, const T* __restrict__ kb,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const uint8_t* __restrict__ bits_a,
                             const uint8_t* __restrict__ bits_b, const int* __restrict__ seed,
                             T* __restrict__ dqa, T* __restrict__ dka, T* __restrict__ dqb,
                             T* __restrict__ dkb, T* __restrict__ dv, int P, int H,
                             int threshold, float scale) {
  using L = Layout<T, HD, MASK>;
  constexpr int kThreads = L::kThreads, kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  T* const sA = tiles + L::kA;
  T* const sB = tiles + L::kB;
  T* const sV = tiles + L::kV;
  T* const sG = tiles + L::kG;
  uint8_t* const sMaskA = smem + L::kMask;
  uint8_t* const sMaskB = sMaskA + L::kRowsA * kWin;

  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * L::kRowsA;   // the block's first row
  const int rb = r0 - kHalfWin;            // the first row of its phase-B windows
  const int sample = blockIdx.z, head = blockIdx.y;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(sample) * P * row_stride +
                         static_cast<long long>(head) * HD;
  // Buffer row i of a window-major tile (q: kind 0, k: kind 1).
  auto window_row = [](T* t, int kind) {
    return [t, kind](int i) { return t + (i / kWin) * L::kWindow + (kind * kWin + i % kWin) * kLd; };
  };
  auto flat_row = [](T* t) { return [t](int i) { return t + i * kLd; }; };

  copy_rows<T, HD, kThreads>(window_row(sA, 0), qa, base, row_stride, r0, L::kRowsA, P);
  copy_rows<T, HD, kThreads>(window_row(sA, 1), ka, base, row_stride, r0, L::kRowsA, P);
  copy_rows<T, HD, kThreads>(window_row(sB, 0), qb, base, row_stride, rb, L::kRowsB, P);
  copy_rows<T, HD, kThreads>(window_row(sB, 1), kb, base, row_stride, rb, L::kRowsB, P);
  copy_rows<T, HD, kThreads>(flat_row(sV), v, base, row_stride, rb, L::kRowsB, P);
  copy_rows<T, HD, kThreads>(flat_row(sG), g, base, row_stride, rb, L::kRowsB, P);
  // A phase-B window starting at row s exists where it lies inside [8, P - 8).
  auto b_exists = [P](int s) { return s >= 0 && s + kWin <= P; };
  if (MASK != kMaskNone) {
    // Bits: one plane per phase, core = head.  Philox: core = phase * H + head.
    const MaskPlane plane_a = make_mask_plane<MASK>(bits_a, seed, sample, head, H, P);
    const MaskPlane plane_b = MASK == kMaskBits
                                  ? make_mask_plane<MASK>(bits_b, seed, sample, head, H, P)
                                  : make_mask_plane<MASK>(nullptr, seed, sample, H + head, 2 * H, P);
    // Eight bytes per step: phase-A row i, then phase-B row i, each at its
    // window's first column.
    for (int i = threadIdx.x; i < 2 * (L::kRowsA + L::kRowsB); i += kThreads) {
      const int half = i & 1, line = i >> 1;
      const bool phase_b = line >= L::kRowsA;
      const int li = phase_b ? line - L::kRowsA : line;
      const int row = (phase_b ? rb : r0) + li;
      const int first = (phase_b ? rb : r0) + kWin * (li / kWin);
      if (phase_b ? !b_exists(first) : row >= P) continue;
      uint8_t* dst = (phase_b ? sMaskB : sMaskA) + li * kWin + 8 * half;
      const MaskPlane& plane = phase_b ? plane_b : plane_a;
      if (MASK == kMaskBits) {
        cp_async8(dst, plane.bits + static_cast<long long>(row) * P + first + 8 * half);
      } else {
        *reinterpret_cast<uint2*>(dst) = mask_bytes8<MASK>(plane, row, first + 8 * half, P);
      }
    }
  }
  cp_commit();
  cp_wait<0>();
  own_pieces<T, HD, kThreads>(window_row(sA, 0), r0, L::kRowsA, [scale](int) { return scale; });
  own_pieces<T, HD, kThreads>(window_row(sB, 0), rb, L::kRowsB, [scale](int) { return scale; });
  own_pieces<T, HD, kThreads>(flat_row(sG), rb, L::kRowsB, [P](int row) {
    return row >= kHalfWin && row < P - kHalfWin ? 0.5f : 1.f;
  });
  __syncthreads();

  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
  T* const tile = tiles + L::kT + warp * kWin * L::kTp;
  const int hi = min(r0 + L::kRowsA, P);  // the block's rows below P
  // Phase-B window `warp`; one that does not exist stores zeros.
  const int sb = rb + kWin * warp;
  window_core<T, HD, MASK>(b_exists(sb), sB + warp * L::kWindow, sV + kWin * warp * kLd,
                               sG + kWin * warp * kLd, sMaskB + warp * kWin * kWin, tile, dqb,
                               dkb, base, row_stride, sb, r0, hi, threshold, keep_inv, scale);
  // Phase-A window `warp`.
  const int sa = r0 + kWin * warp;
  if (warp < L::NA && sa < P)
    window_core<T, HD, MASK>(true, sA + warp * L::kWindow,
                                 sV + (kHalfWin + kWin * warp) * kLd,
                                 sG + (kHalfWin + kWin * warp) * kLd, sMaskA + warp * kWin * kWin,
                                 tile, dqa, dka, base, row_stride, sa, r0, hi, threshold,
                                 keep_inv, scale);
  __syncthreads();

  // dv = round_T(dv_a + dv_b), 16 bytes per store.
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < L::kRowsA * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * kVec;
    if (r0 + r >= P) break;
    const float* a = reinterpret_cast<const float*>(sA + (r / kWin) * L::kWindow) +
                     (r % kWin) * L::kSp + c;
    const int rbuf = r + kHalfWin;
    const float* b = reinterpret_cast<const float*>(sB + (rbuf / kWin) * L::kWindow) +
                     (rbuf % kWin) * L::kSp + c;
    alignas(16) T out[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = from_float<T>(a[e] + b[e]);
    *reinterpret_cast<uint4*>(dv + base + static_cast<long long>(r0 + r) * row_stride + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T, int HD, int MASK>
cudaError_t launch(const LocalGradsArgs& a) {
  using L = Layout<T, HD, MASK>;
  const cudaError_t err = cudaFuncSetAttribute(
      local_two_phase_grads_kernel<T, HD, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.P + L::kRowsA - 1) / L::kRowsA, a.H, a.B);
  local_two_phase_grads_kernel<T, HD, MASK><<<grid, L::kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.qa), static_cast<const T*>(a.ka), static_cast<const T*>(a.qb),
      static_cast<const T*>(a.kb), static_cast<const T*>(a.v), static_cast<const T*>(a.g),
      static_cast<const uint8_t*>(a.bits_a), static_cast<const uint8_t*>(a.bits_b),
      static_cast<const int*>(a.seed), static_cast<T*>(a.dqa), static_cast<T*>(a.dka),
      static_cast<T*>(a.dqb), static_cast<T*>(a.dkb), static_cast<T*>(a.dv), a.P, a.H,
      a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const LocalGradsArgs& a) {
  if (a.bits_a != nullptr) return launch<T, HD, kMaskBits>(a);
  if (a.seed != nullptr) return launch<T, HD, kMaskPhilox>(a);
  return launch<T, HD, kMaskNone>(a);
}

template <typename T>
cudaError_t dispatch_hd(const LocalGradsArgs& a, int hd) {
  switch (hd) {
    case 16: return dispatch_mask<T, 16>(a);
    case 32: return dispatch_mask<T, 32>(a);
    case 64: return dispatch_mask<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
