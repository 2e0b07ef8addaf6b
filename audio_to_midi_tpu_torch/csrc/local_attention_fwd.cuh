// The two-phase local (sliding-window) attention forward: window 16, stride
// 8, with the overlap average, in padded coordinates, on the tensor cores.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_local_two_phase
// (:608, _two_phase_impl :563 -> _two_phase_core :478-542; kernel 2),
// fused_local_two_phase_dropout (:697, precomputed uint8 bits (B, H, P, P)
// per phase; kernel 5) and _two_phase_drop_prng_impl (:1622, bytes drawn
// from a seed, stream (sample, phase * H + head); kernel 12).  The mask
// source is a template parameter of the one body, as get_bits is of
// _two_phase_core.  The body computes what _two_phase_core computes, in its
// order:
//   logits = round_T(q * scale) . k^T in fp32, over the window's 16 keys;
//   w = their fp32 softmax, normalized;
//   w = w * 256 / (256 - threshold) where the mask byte >= threshold, else 0;
//   out_p = round_T(w) . v in fp32, per phase p;
//   out_b = 0 outside [8, P - 8);
//   out = round_T((out_a + out_b) * (0.5 inside [8, P - 8), 1 outside)).
// The TPU kernel builds P x P masked logits per (sample, phase, head),
// because its matrix unit wants large tiles; the keys outside a row's window
// get exp(-1e30 - m) = 0 there, so 16 keys per row and phase give the same
// sums.  Phase A: window w holds rows and keys 16w .. 16w + 15.  Phase B:
// windows 16u + 8 .. 16u + 23 (u = 0 .. P/16 - 2), which hold only rows of
// [8, P - 8); the rows outside have no phase-B window (the TPU kernel
// softmaxes their fully masked logits and zeroes what comes out).
//
// What bounds it on the card: bytes.  It reads 5 tensors of B x P x H*hd and
// writes one -- at the training shapes (32, 256, 256) 25 MB in bf16 (0.0075
// ms at 3.35 TB/s) and 50 MB in f32 (0.0150 ms) -- against 0.13 GFLOP of
// products.  The scalar body this replaces (a lane per (row, key) pair,
// scalar loads, fp32 products walking the head dim over shared memory) ran
// at ~5x that bound in f32 and bf16 alike: its own instructions set its
// pace, not the bytes.
//
// The design: that of the backward (local_attention_bwd.cuh), with two
// products instead of five.
//   * A block of NA + 1 warps owns the rows r0 .. r0 + 16 NA - 1 (NA =
//     kBlockWindows phase-A windows) of one (sample, head).  Warp w computes
//     the phase-B window that starts at r0 - 8 + 16 w and, for w < NA, the
//     phase-A window that starts at r0 + 16 w: the NA + 1 phase-B windows
//     that touch the block's rows, the edge ones half used.  Phase B is
//     recomputed (NA + 1) / NA times, with no atomics and no scratch in
//     device memory, so a call repeats bit for bit.
//   * The rows are copied once with 16-byte cp.async: r0 .. of qa and ka, r0
//     - 8 .. of qb, kb and v (16 NA + 16 rows), zero outside [0, P); the
//     copying thread scales its pieces of q in T.  The mask bytes: Philox
//     drawn into shared memory by the threads at the (row, column) the TPU
//     kernel takes them from -- a phase-B window starts 8 columns into a
//     16-column Philox group, so its row takes the upper half of one group
//     and the lower half of the next -- bits by 8-byte cp.async.
//   * A window runs on the tensor cores (mma_tile.cuh): bf16 mma.sync
//     m16n8k16 with fp32 accumulation, f32 as 3xTF32 m16n8k8.  S = Q K^T is
//     a 16 x 16 accumulator pair; the softmax and the mask run on its
//     fragments (a row's 16 values sit in one quad of lanes: two shuffles
//     per reduction); the weights go from those registers straight into the
//     A operand of W V, rounded to T on the way (pack_a); V is the B operand,
//     loaded by ldmatrix .trans (bf16) or in load_bt's depth order (f32).
//   * Each window's fp32 output goes to shared memory over its spent q and k
//     rows; after one barrier each row's two phases are added (fp32 addition
//     of two terms: the order cannot matter), scaled, rounded once and
//     stored 16 bytes at a time.
// The copies and the scaling are the backward's (local_window.cuh).

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "local_window.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace a2m {

// The launch arguments, as the C entry (local_attention.cu) receives them.
struct LocalArgs {
  const void *qa, *ka, *qb, *kb, *v, *bits_a, *bits_b, *seed;
  void* out;
  int B, P, H, threshold;
  float scale;
  cudaStream_t stream;
};

// The launches of one dtype, in local_attention_fwd_{f32,bf16}.cu: the
// instantiations of each dtype compile in parallel.
cudaError_t local_two_phase_f32(const LocalArgs& a, int hd);
cudaError_t local_two_phase_bf16(const LocalArgs& a, int hd);

}  // namespace a2m

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh)

// Phase-A windows per block (NA below): 64 rows.  Blocks of 32 rows were
// slower on the H100 at 16, 32 and 128 windows, in bf16 and f32.
constexpr int kBlockWindows = 4;

// Where everything of a block lies in its dynamic shared memory, in elements
// of T from the start (the mask bytes: in bytes).
template <typename T, int HD, int MASK>
struct Layout {
  static constexpr int NA = kBlockWindows;
  static constexpr int kWarps = NA + 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsA = kWin * NA;      // the block's rows
  static constexpr int kRowsB = kRowsA + kWin;  // its phase-B windows' rows
  static constexpr int kLd = pitch<T, HD>();    // a row of a q, k or v tile
  static constexpr int kSp = HD + 8;            // a row of a staged output, floats
  // One window: its 16 q rows, then its 16 k rows.
  static constexpr int kWindow = 2 * kWin * kLd;
  static constexpr int kA = 0;                      // NA phase-A windows
  static constexpr int kB = kA + NA * kWindow;      // NA + 1 phase-B windows
  static constexpr int kV = kB + kWarps * kWindow;  // kRowsB rows of v
  static constexpr int kMask = (kV + kRowsB * kLd) * static_cast<int>(sizeof(T));
  // Mask bytes, 16 per row: the kRowsA phase-A rows, then the kRowsB phase-B rows.
  static constexpr size_t kBytes =
      kMask + (MASK == kMaskNone ? 0 : (kRowsA + kRowsB) * kWin);
  static_assert(kWin * kSp * sizeof(float) <= kWindow * sizeof(T),
                "a window's output fits over its q and k rows");
  static_assert(kMask % 16 == 0 && kLd * sizeof(T) % 16 == 0, "aligned rows");
};

// The mask bytes of a block whose rows_a phase-A rows start at r0 and whose
// rows_b phase-B rows start at rb = r0 - 8, 16 per row at its window's first
// column, into mask_a and mask_b: Philox drawn by the threads; bits by
// 8-byte cp.async, which the caller waits for with its rows' copies.  The
// rows of a phase-A window at or past P, and of a phase-B window that does
// not lie inside [8, P - 8), are left as they are.  The backward's kernel
// has the same loop written out: moved into this function there, its
// instantiations with a mask compiled to other SASS.
template <int MASK, int THREADS>
__device__ __forceinline__ void load_masks(uint8_t* mask_a, uint8_t* mask_b,
                                           const uint8_t* __restrict__ bits_a,
                                           const uint8_t* __restrict__ bits_b,
                                           const int* __restrict__ seed, int sample, int head,
                                           int H, int P, int r0, int rb, int rows_a,
                                           int rows_b) {
  if (MASK == kMaskNone) return;
  // Bits: one plane per phase, core = head.  Philox: core = phase * H + head.
  const MaskPlane plane_a = make_mask_plane<MASK>(bits_a, seed, sample, head, H, P);
  const MaskPlane plane_b = MASK == kMaskBits
                                ? make_mask_plane<MASK>(bits_b, seed, sample, head, H, P)
                                : make_mask_plane<MASK>(nullptr, seed, sample, H + head, 2 * H, P);
  // Eight bytes per step: phase-A row i, then phase-B row i, each at its
  // window's first column.
  for (int i = threadIdx.x; i < 2 * (rows_a + rows_b); i += THREADS) {
    const int half = i & 1, line = i >> 1;
    const bool phase_b = line >= rows_a;
    const int li = phase_b ? line - rows_a : line;
    const int row = (phase_b ? rb : r0) + li;
    const int first = (phase_b ? rb : r0) + kWin * (li / kWin);
    if (phase_b ? !(first >= 0 && first + kWin <= P) : row >= P) continue;
    uint8_t* dst = (phase_b ? mask_b : mask_a) + li * kWin + 8 * half;
    const MaskPlane& plane = phase_b ? plane_b : plane_a;
    if (MASK == kMaskBits) {
      cp_async8(dst, plane.bits + static_cast<long long>(row) * P + first + 8 * half);
    } else {
      *reinterpret_cast<uint2*>(dst) = mask_bytes8<MASK>(plane, row, first + 8 * half, P);
    }
  }
}

// One window of the warp: out = round_T(mask(softmax(q k^T))) . v in fp32,
// staged (fp32, pitch kSp) over the window's q and k rows.  q (scaled), k:
// the window's 16 rows each, pitch pitch<T, HD>; v: its 16 key rows; mask:
// its 16 x 16 bytes.  A window that does not exist stages zeros.
template <typename T, int HD, int MASK>
__device__ __forceinline__ void window_out(bool exists, T* window, const T* v,
                                           const uint8_t* mask, int threshold,
                                           float keep_inv) {
  using L = Layout<T, HD, MASK>;
  const int lane = threadIdx.x & 31, grp = lane >> 2, quad = lane & 3;
  float acc[HD / 8][4];
  zero<HD>(acc);
  if (exists) {
    float s[2][4];
    {
      const Resident<T, HD> rq(window, 0);
      chunk_product<T, HD>(s, rq, window + kWin * L::kLd, 0);
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
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = s[j][e] / l;
          if (MASK != kMaskNone)
            s[j][e] = apply_mask_byte(
                s[j][e], mask[(grp + 8 * r) * kWin + 8 * j + 2 * quad + (e & 1)], threshold,
                keep_inv);
        }
    }
    accumulate_product<T, HD>(acc, s, v, 0);
  }
  float* stage = reinterpret_cast<float*>(window);
  __syncwarp();  // every lane is done with the window's q and k rows
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(stage + (grp + 8 * r) * L::kSp + 8 * n + 2 * quad) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(Layout<T, HD, MASK>::kThreads)
local_two_phase_fwd_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                           const T* __restrict__ qb, const T* __restrict__ kb,
                           const T* __restrict__ v, const uint8_t* __restrict__ bits_a,
                           const uint8_t* __restrict__ bits_b, const int* __restrict__ seed,
                           T* __restrict__ out, int P, int H, int threshold, float scale) {
  using L = Layout<T, HD, MASK>;
  constexpr int kThreads = L::kThreads, kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  T* const sA = tiles + L::kA;
  T* const sB = tiles + L::kB;
  T* const sV = tiles + L::kV;
  uint8_t* const sMaskA = smem + L::kMask;
  uint8_t* const sMaskB = sMaskA + L::kRowsA * kWin;

  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * L::kRowsA;  // the block's first row
  const int rb = r0 - kHalfWin;           // the first row of its phase-B windows
  const int sample = blockIdx.z, head = blockIdx.y;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(sample) * P * row_stride +
                         static_cast<long long>(head) * HD;
  // Buffer row i of a window-major tile (q: kind 0, k: kind 1).
  auto window_row = [](T* t, int kind) {
    return [t, kind](int i) { return t + (i / kWin) * L::kWindow + (kind * kWin + i % kWin) * kLd; };
  };

  copy_rows<T, HD, kThreads>(window_row(sA, 0), qa, base, row_stride, r0, L::kRowsA, P);
  copy_rows<T, HD, kThreads>(window_row(sA, 1), ka, base, row_stride, r0, L::kRowsA, P);
  copy_rows<T, HD, kThreads>(window_row(sB, 0), qb, base, row_stride, rb, L::kRowsB, P);
  copy_rows<T, HD, kThreads>(window_row(sB, 1), kb, base, row_stride, rb, L::kRowsB, P);
  copy_rows<T, HD, kThreads>([sV](int i) { return sV + i * kLd; }, v, base, row_stride, rb,
                             L::kRowsB, P);
  load_masks<MASK, kThreads>(sMaskA, sMaskB, bits_a, bits_b, seed, sample, head, H, P, r0, rb,
                             L::kRowsA, L::kRowsB);
  cp_commit();
  cp_wait<0>();
  own_pieces<T, HD, kThreads>(window_row(sA, 0), r0, L::kRowsA, [scale](int) { return scale; });
  own_pieces<T, HD, kThreads>(window_row(sB, 0), rb, L::kRowsB, [scale](int) { return scale; });
  __syncthreads();

  const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
  // Phase-B window `warp`, which exists where it lies inside [8, P - 8); one
  // that does not stages zeros.
  const int sb = rb + kWin * warp;
  window_out<T, HD, MASK>(sb >= 0 && sb + kWin <= P, sB + warp * L::kWindow,
                          sV + kWin * warp * kLd, sMaskB + warp * kWin * kWin, threshold,
                          keep_inv);
  // Phase-A window `warp`.
  if (warp < L::NA && r0 + kWin * warp < P)
    window_out<T, HD, MASK>(true, sA + warp * L::kWindow, sV + (kHalfWin + kWin * warp) * kLd,
                            sMaskA + warp * kWin * kWin, threshold, keep_inv);
  __syncthreads();

  // out = round_T((out_a + out_b) * (0.5 inside [8, P - 8), 1 outside)), 16
  // bytes per store.  out_b is 0 outside: those rows' windows staged zeros.
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < L::kRowsA * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * kVec, row = r0 + r;
    if (row >= P) break;
    const float* a = reinterpret_cast<const float*>(sA + (r / kWin) * L::kWindow) +
                     (r % kWin) * L::kSp + c;
    const int rbuf = r + kHalfWin;
    const float* b = reinterpret_cast<const float*>(sB + (rbuf / kWin) * L::kWindow) +
                     (rbuf % kWin) * L::kSp + c;
    const float mul = row >= kHalfWin && row < P - kHalfWin ? 0.5f : 1.f;
    alignas(16) T o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = from_float<T>((a[e] + b[e]) * mul);
    *reinterpret_cast<uint4*>(out + base + static_cast<long long>(row) * row_stride + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T, int HD, int MASK>
cudaError_t launch(const LocalArgs& a) {
  using L = Layout<T, HD, MASK>;
  const cudaError_t err = cudaFuncSetAttribute(
      local_two_phase_fwd_kernel<T, HD, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.P + L::kRowsA - 1) / L::kRowsA, a.H, a.B);
  local_two_phase_fwd_kernel<T, HD, MASK><<<grid, L::kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.qa), static_cast<const T*>(a.ka), static_cast<const T*>(a.qb),
      static_cast<const T*>(a.kb), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.bits_a), static_cast<const uint8_t*>(a.bits_b),
      static_cast<const int*>(a.seed), static_cast<T*>(a.out), a.P, a.H, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const LocalArgs& a) {
  if (a.bits_a != nullptr) return launch<T, HD, kMaskBits>(a);
  if (a.seed != nullptr) return launch<T, HD, kMaskPhilox>(a);
  return launch<T, HD, kMaskNone>(a);
}

template <typename T>
cudaError_t dispatch_hd(const LocalArgs& a, int hd) {
  switch (hd) {
    case 16: return dispatch_mask<T, 16>(a);
    case 32: return dispatch_mask<T, 32>(a);
    case 64: return dispatch_mask<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
