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

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;
constexpr int kThreads = kWindow * kWindow;  // one lane per (row, key) pair

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
local_two_phase_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                       const T* __restrict__ qb, const T* __restrict__ kb,
                       const T* __restrict__ v, T* __restrict__ out, int P, int H,
                       float scale) {
  __shared__ float sQa[kWindow][HD + 1];
  __shared__ float sKa[kWindow][HD + 1];
  __shared__ float sQb[kWindow][HD + 1];
  __shared__ float sKb[2 * kWindow][HD + 1];  // rows 16w-8 .. 16w+23
  __shared__ float sV[2 * kWindow][HD];       // rows 16w-8 .. 16w+23
  __shared__ float sPa[kWindow][kWindow + 1];
  __shared__ float sPb[kWindow][kWindow + 1];

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
  sPa[r][j] = ea / la;
  sPb[r][j] = band ? eb / lb : 0.f;
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

template <typename T, int HD>
cudaError_t launch(const void* qa, const void* ka, const void* qb, const void* kb,
                   const void* v, void* out, int B, int P, int H, float scale,
                   cudaStream_t stream) {
  const dim3 grid(P / kWindow, H, B);
  local_two_phase_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(ka), static_cast<const T*>(qb),
      static_cast<const T*>(kb), static_cast<const T*>(v), static_cast<T*>(out), P, H,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qa, const void* ka, const void* qb, const void* kb,
                        const void* v, void* out, int B, int P, int H, int hd, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(qa, ka, qb, kb, v, out, B, P, H, scale, stream);
    case 32: return launch<T, 32>(qa, ka, qb, kb, v, out, B, P, H, scale, stream);
    case 64: return launch<T, 64>(qa, ka, qb, kb, v, out, B, P, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qa, ka, qb, kb, v, out: contiguous (B, P, H*hd) device buffers of one
// dtype, P a multiple of 16.  Returns the cudaError_t of the launch.
extern "C" int a2m_local_two_phase(const void* qa, const void* ka, const void* qb,
                                   const void* kb, const void* v, void* out, int B, int P,
                                   int H, int hd, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % kWindow != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case a2m::kFloat32:
      return dispatch_hd<float>(qa, ka, qb, kb, v, out, B, P, H, hd, scale, st);
    case a2m::kBFloat16:
      return dispatch_hd<__nv_bfloat16>(qa, ka, qb, kb, v, out, B, P, H, hd, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
