// Two-phase local (sliding-window) attention: window 16, stride 8, with the
// overlap average, in padded coordinates.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_local_two_phase
// (:608, _two_phase_impl -> _two_phase_kernel -> _two_phase_core,
// :478-574).  The TPU kernel builds P x P masked logits per (sample, phase,
// head) because its matrix unit wants large tiles.  Here every row attends
// to exactly 16 keys per phase, so the kernel computes only those:
//   * phase A: row r of window w (rows 16w..16w+15) attends to keys
//     16w..16w+15;
//   * phase B (window shifted by 8): rows in [8, P-8) attend to the 16 keys
//     of the shifted window that holds them -- keys 16w-8..16w+7 for the
//     first half of window w and 16w+8..16w+23 for the second half.  The
//     TPU mask reaches this through (r - 8) // 16, which floors for r < 8;
//     taking the half-window from r's position inside w avoids any division
//     of a negative row;
//   * rows outside [8, P-8) have no phase-B window and skip it.  The TPU
//     kernel softmaxes their fully masked logits and then zeroes them, so
//     the values agree;
//   * out = (out_a + out_b) / 2 inside [8, P-8), out_a outside.
// Softmax and both products accumulate in fp32; q is scaled in its dtype.
//
// What bounds it on the card: memory.  Per (sample, head, window) it does
// 2 x 16 x 16 x hd MACs for the logits and as many for the outputs, and it
// reads 5 tensors of B x P x H*hd once (k_b and v for 32 rows, half of which
// the neighbouring window reads too, from L2) and writes one -- at the
// serving shapes ~6 x 16 x 256 x 256 elements, ~25 MB in f32, against
// ~0.13 GFLOP.  Design: one block of 256 threads per (16-row window, head,
// sample), 16 lanes per query row so a row's softmax reduces in 4 shuffles
// inside one warp, every input element loaded into shared memory once.
//
// Dropout on the attention weights is a template parameter of the one body,
// as `get_bits` is of the TPU's _two_phase_core: none, precomputed uint8
// bits (B, H, P, P) per phase (fused_local_two_phase_dropout, :697) or
// Philox bytes drawn in the kernel from a seed in device memory
// (_two_phase_drop_prng_impl, :1622; stream = (sample, phase * H + head)).
// The planes keep the TPU kernel's P x P shape, but only the in-window bytes
// are read or drawn: 2 x 16 bytes per row, at the (row, column) the TPU
// kernel would take them from.  A phase-B window starts 8 columns into a
// 16-column Philox group, so its row takes the upper half of one group and
// the lower half of the next; 64 threads fetch the 8-byte halves of both
// phases into shared memory before the one barrier.  The mask goes on the
// normalized fp32 weights, kept ones scaled by 256 / (256 - threshold).

#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;
constexpr int kThreads = kWindow * kWindow;  // one lane per (row, key) pair

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads)
local_two_phase_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                       const T* __restrict__ qb, const T* __restrict__ kb,
                       const T* __restrict__ v, const uint8_t* __restrict__ bits_a,
                       const uint8_t* __restrict__ bits_b, const int* __restrict__ seed,
                       T* __restrict__ out, int P, int H, int threshold, float scale) {
  __shared__ float sQa[kWindow][HD + 1];
  __shared__ float sKa[kWindow][HD + 1];
  __shared__ float sQb[kWindow][HD + 1];
  __shared__ float sKb[2 * kWindow][HD + 1];  // rows 16w-8 .. 16w+23
  __shared__ float sV[2 * kWindow][HD];       // rows 16w-8 .. 16w+23
  __shared__ float sPa[kWindow][kWindow + 1];
  __shared__ float sPb[kWindow][kWindow + 1];
  // Mask bytes [phase][row][key / 4], four keys to a word.
  __shared__ uint32_t sMask[MASK == a2m::kMaskNone ? 1 : 2][kWindow][kWindow / 4];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kWindow;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(blockIdx.z) * P * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;

  for (int i = tid; i < kWindow * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const long long off = base + (r0 + r) * row_stride + d;
    sQa[r][d] = a2m::scaled_in_dtype(qa[off], scale);
    sKa[r][d] = a2m::to_float(ka[off]);
    sQb[r][d] = a2m::scaled_in_dtype(qb[off], scale);
  }
  for (int i = tid; i < 2 * kWindow * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = r0 - kStride + r;
    const bool inside = row >= 0 && row < P;
    const long long off = base + row * row_stride + d;
    sKb[r][d] = inside ? a2m::to_float(kb[off]) : 0.f;
    sV[r][d] = inside ? a2m::to_float(v[off]) : 0.f;
  }
  if (MASK != a2m::kMaskNone && tid < 4 * kWindow) {
    // Thread (phase, row, half) fetches 8 bytes of that row's window.
    const int phase = tid / (2 * kWindow);
    const int mr = (tid / 2) % kWindow;
    const int half = tid % 2;
    const int mrow = r0 + mr;
    const int first = phase == 0 ? r0 : (mr < kStride ? r0 - kStride : r0 + kStride);
    if (phase == 0 || (mrow >= kStride && mrow < P - kStride)) {
      // Bits: one plane per phase, core = head.  Philox: core = phase * H + head.
      const a2m::MaskPlane plane =
          MASK == a2m::kMaskBits
              ? a2m::make_mask_plane<MASK>(phase == 0 ? bits_a : bits_b, seed, blockIdx.z,
                                           blockIdx.y, H, P)
              : a2m::make_mask_plane<MASK>(nullptr, seed, blockIdx.z, phase * H + blockIdx.y,
                                           2 * H, P);
      const uint2 bytes = a2m::mask_bytes8<MASK>(plane, mrow, first + kStride * half, P);
      sMask[phase][mr][2 * half] = bytes.x;
      sMask[phase][mr][2 * half + 1] = bytes.y;
    }
  }
  __syncthreads();

  const int r = tid / kWindow;  // query row within the window
  const int j = tid % kWindow;  // key within the row's window
  const int row = r0 + r;
  const bool band = row >= kStride && row < P - kStride;
  const int b_first = r < kStride ? 0 : kWindow;  // first sKb/sV row of the phase-B window

  float sa = 0.f;
  float sb = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) sa = fmaf(sQa[r][d], sKa[j][d], sa);
  if (band) {
#pragma unroll 16
    for (int d = 0; d < HD; ++d) sb = fmaf(sQb[r][d], sKb[b_first + j][d], sb);
  }

  // Softmax over the 16 aligned lanes that hold the row.
  float ma = sa;
  float mb = sb;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }
  const float ea = expf(sa - ma);
  const float eb = expf(sb - mb);
  float la = ea;
  float lb = eb;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }
  float wa = ea / la;
  float wb = band ? eb / lb : 0.f;
  if (MASK != a2m::kMaskNone) {
    const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
    const int shift = 8 * (j % 4);
    wa = a2m::apply_mask_byte(wa, (sMask[0][r][j / 4] >> shift) & 255, threshold, keep_inv);
    if (band)
      wb = a2m::apply_mask_byte(wb, (sMask[1][r][j / 4] >> shift) & 255, threshold, keep_inv);
  }
  sPa[r][j] = wa;
  sPb[r][j] = wb;
  __syncwarp();  // a row's weights are written and read by its own 16 lanes

#pragma unroll
  for (int i = 0; i < HD / kWindow; ++i) {
    const int d = j + kWindow * i;
    float oa = 0.f;
    float ob = 0.f;
#pragma unroll
    for (int c = 0; c < kWindow; ++c) {
      oa = fmaf(sPa[r][c], sV[kStride + c][d], oa);
      ob = fmaf(sPb[r][c], sV[b_first + c][d], ob);
    }
    const float o = band ? (oa + ob) * 0.5f : oa;
    out[base + row * row_stride + d] = a2m::from_float<T>(o);
  }
}

struct Args {
  const void *qa, *ka, *qb, *kb, *v, *bits_a, *bits_b, *seed;
  void* out;
  int B, P, H, threshold;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int MASK>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.P / kWindow, a.H, a.B);
  local_two_phase_kernel<T, HD, MASK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.qa), static_cast<const T*>(a.ka), static_cast<const T*>(a.qb),
      static_cast<const T*>(a.kb), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.bits_a), static_cast<const uint8_t*>(a.bits_b),
      static_cast<const int*>(a.seed), static_cast<T*>(a.out), a.P, a.H, a.threshold, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_mask(const Args& a) {
  if (a.bits_a != nullptr) return launch<T, HD, a2m::kMaskBits>(a);
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

// qa, ka, qb, kb, v, out: contiguous (B, P, H*hd) device buffers of one
// dtype, P a multiple of 16.  Either bits_a and bits_b (contiguous
// (B, H, P, P) uint8, one per phase) or seed ((2,) int32 in device memory)
// may be given, with threshold in (0, 256); all null: no dropout.  Returns
// the cudaError_t of the launch.
extern "C" int a2m_local_two_phase(const void* qa, const void* ka, const void* qb,
                                   const void* kb, const void* v, const void* bits_a,
                                   const void* bits_b, const void* seed, void* out, int B,
                                   int P, int H, int hd, int threshold, float scale, int dtype,
                                   void* stream) {
  if (P % kWindow != 0) return cudaErrorInvalidValue;
  const bool with_bits = bits_a != nullptr || bits_b != nullptr;
  const bool dropout = with_bits || seed != nullptr;
  if ((with_bits && (bits_a == nullptr || bits_b == nullptr || seed != nullptr)) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  const Args a = {qa, ka, qb, kb, v, bits_a, bits_b, seed, out, B, P, H, threshold, scale,
                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
