// Backward of the two-phase local (sliding-window) attention: dqa, dka, dqb,
// dkb and dv from the five inputs and the cotangent g of the overlap-averaged
// output, window 16, stride 8, in padded coordinates.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py two_phase_grads (:992,
// _two_phase_bwd_kernel), two_phase_grads_drop (:1025, precomputed uint8
// bits (B, H, P, P) per phase) and two_phase_grads_drop_prng (:1682, bytes
// drawn from the forward's seed), all of them _two_phase_bwd_core ->
// _core_grads, :880-968.  The mask source is a template parameter of the one
// body, as in local_attention.cu; a kept weight w and its dw are scaled by
// 256 / (256 - threshold), dropped ones are 0, delta sums dw * w over the
// undropped w.
// The TPU kernel recomputes two P x P masked logit matrices per (sample,
// head) because its matrix unit wants large tiles.  Here every row has 16
// keys per phase, as in local_attention.cu, so a core is one 16 x 16 window:
//   g' = g * (0.5 inside [8, P-8), 1 at the edges), in fp32 (exact in T);
//   w = softmax(round_T(q * scale) . k^T) over the window's 16 keys;
//   dv = round_T(w)^T . g';   dw = g' . v^T;
//   dlogits = round_T(w * (dw - sum_c dw w));
//   dq = (dlogits . k) * scale;   dk = dlogits^T . round_T(q * scale).
// Phase A uses windows 16w..16w+15 with every row's g'; phase B uses windows
// 16u+8..16u+23 (u = 0 .. P/16-2), which hold only rows of [8, P-8) -- the
// rows outside have no phase B, which is what the TPU kernel's zeroed g and
// in_band column mask come to.  dv = round_T(dv_a + dv_b), summed in fp32.
//
// What bounds it on the card: memory.  It reads 6 and writes 5 tensors of
// B x P x H*hd once -- at the training shapes (32, 256, 256) 46 MB in bf16
// and 92 MB in f32 -- against 0.67 GFLOP of useful products.
//
// The trouble of this backward is that dk_b and dv of a row collect from a
// phase-B window that straddles two phase-A windows, so a block per phase-A
// window that scattered its phase-B terms would race with its neighbour.
// Design: one block of 256 threads owns the 16 output rows 16w..16w+15 of
// one (sample, head) and recomputes BOTH phase-B windows that touch them
// (rows 16w-8..16w+7 and 16w+8..16w+23) from the 32 rows 16w-8..16w+23 of
// qb, kb, v and g, which it loads once.  That doubles the phase-B
// arithmetic, which is negligible beside the memory traffic, needs no
// atomics and no scratch, and gives results that repeat bit for bit.  The
// neighbour's half of those 32 rows comes from L2.  One lane per (row, key)
// pair computes the window weights (a row's softmax and delta reduce in 4
// shuffles over 16 aligned lanes); after one barrier the same lane computes
// hd/16 columns of its row's five outputs.  A row's phase-B window is taken
// from its half of the phase-A window, so no negative row is ever divided.

#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;
constexpr int kThreads = kWindow * kWindow;  // one lane per (row, key) pair

// One (row r, key j) entry of a 16 x 16 core: the rounded weight and the
// rounded dlogit.  q_row/g_row: the row's scaled q and g'; k_row/v_row: the
// key's k and v; each HD floats.  The 16 lanes of a row are aligned.
// mask_words: the row's 16 mask bytes, four keys to a word.
template <typename T, int HD, int MASK>
__device__ __forceinline__ void core_entry(const float* q_row, const float* k_row,
                                           const float* g_row, const float* v_row,
                                           const uint32_t* mask_words, int j, int threshold,
                                           float* w_out, float* dl_out) {
  float s = 0.f;
  float dw = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) {
    s = fmaf(q_row[d], k_row[d], s);
    dw = fmaf(g_row[d], v_row[d], dw);
  }
  float m = s;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = expf(s - m);
  float l = e;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float w = e / l;
  float w_used = w;
  if (MASK != a2m::kMaskNone) {
    const float keep_inv = 256.f / (256.f - static_cast<float>(threshold));
    const int byte = (mask_words[j / 4] >> (8 * (j % 4))) & 255;
    w_used = a2m::apply_mask_byte(w, byte, threshold, keep_inv);
    dw = a2m::apply_mask_byte(dw, byte, threshold, keep_inv);
  }
  float delta = dw * w;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, o);
  *w_out = a2m::round_to<T>(w_used);
  *dl_out = a2m::round_to<T>(w * (dw - delta));
}

template <typename T, int HD, int MASK>
__global__ void __launch_bounds__(kThreads)
local_two_phase_grads_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                             const T* __restrict__ qb, const T* __restrict__ kb,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const uint8_t* __restrict__ bits_a,
                             const uint8_t* __restrict__ bits_b, const int* __restrict__ seed,
                             T* __restrict__ dqa, T* __restrict__ dka, T* __restrict__ dqb,
                             T* __restrict__ dkb, T* __restrict__ dv, int P, int H,
                             int threshold, float scale) {
  // The 32-row buffers hold rows 16w-8 .. 16w+23; buffer row 8 + r is the
  // block's output row r.  Rows outside [0, P) are zero.
  __shared__ float sQa[kWindow][HD + 1];
  __shared__ float sKa[kWindow][HD + 1];
  __shared__ float sQb[2 * kWindow][HD + 1];
  __shared__ float sKb[2 * kWindow][HD + 1];
  __shared__ float sV[2 * kWindow][HD + 1];
  __shared__ float sG[2 * kWindow][HD + 1];   // g' = g * inv_count
  __shared__ float sWa[kWindow][kWindow + 1];
  __shared__ float sDLa[kWindow][kWindow + 1];
  __shared__ float sWb[2][kWindow][kWindow + 1];   // the two phase-B windows
  __shared__ float sDLb[2][kWindow][kWindow + 1];
  // Mask bytes of the phase-A window (0) and the two phase-B windows (1, 2),
  // [window][row][key / 4], four keys to a word.
  __shared__ uint32_t sMask[MASK == a2m::kMaskNone ? 1 : 3][kWindow][kWindow / 4];

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
  }
  for (int i = tid; i < 2 * kWindow * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = r0 - kStride + r;
    const bool inside = row >= 0 && row < P;
    const bool band = row >= kStride && row < P - kStride;
    const long long off = base + row * row_stride + d;
    sQb[r][d] = inside ? a2m::scaled_in_dtype(qb[off], scale) : 0.f;
    sKb[r][d] = inside ? a2m::to_float(kb[off]) : 0.f;
    sV[r][d] = inside ? a2m::to_float(v[off]) : 0.f;
    sG[r][d] = inside ? a2m::to_float(g[off]) * (band ? 0.5f : 1.f) : 0.f;
  }
  if (MASK != a2m::kMaskNone && tid < 6 * kWindow) {
    // Thread (window, row, half) fetches 8 bytes of that window's row.  The
    // phase-B windows start at rows (= columns) r0 - 8 and r0 + 8.
    const int win = tid / (2 * kWindow);
    const int mr = (tid / 2) % kWindow;
    const int half = tid % 2;
    const int first = win == 0 ? r0 : (win == 1 ? r0 - kStride : r0 + kStride);
    if (first >= 0 && first + kWindow <= P) {
      const int phase = win == 0 ? 0 : 1;
      // Bits: one plane per phase, core = head.  Philox: core = phase * H + head.
      const a2m::MaskPlane plane =
          MASK == a2m::kMaskBits
              ? a2m::make_mask_plane<MASK>(phase == 0 ? bits_a : bits_b, seed, blockIdx.z,
                                           blockIdx.y, H, P)
              : a2m::make_mask_plane<MASK>(nullptr, seed, blockIdx.z, phase * H + blockIdx.y,
                                           2 * H, P);
      const uint2 bytes =
          a2m::mask_bytes8<MASK>(plane, first + mr, first + kStride * half, P);
      sMask[win][mr][2 * half] = bytes.x;
      sMask[win][mr][2 * half + 1] = bytes.y;
    }
  }
  __syncthreads();

  const int r = tid / kWindow;  // row within the window
  const int j = tid % kWindow;  // key within the window

  core_entry<T, HD, MASK>(sQa[r], sKa[j], sG[kStride + r], sV[kStride + j], sMask[0][r], j,
                          threshold, &sWa[r][j], &sDLa[r][j]);
#pragma unroll
  for (int sel = 0; sel < 2; ++sel) {
    // Window sel covers buffer rows 16 sel .. 16 sel + 15; the first block
    // has no window 0 and the last block no window 1.
    const bool exists = sel == 0 ? r0 > 0 : r0 + kWindow < P;
    float w = 0.f;
    float dl = 0.f;
    if (exists) {  // uniform over the block
      const int first = sel * kWindow;
      core_entry<T, HD, MASK>(sQb[first + r], sKb[first + j], sG[first + r], sV[first + j],
                              sMask[MASK == a2m::kMaskNone ? 0 : 1 + sel][r], j, threshold, &w,
                              &dl);
    }
    sWb[sel][r][j] = w;
    sDLb[sel][r][j] = dl;
  }
  __syncthreads();

  // This lane's output row r: in phase A it is query r and key r of the
  // window; in phase B it is entry `li` of window `sel`.
  const int sel = r < kStride ? 0 : 1;
  const int li = (r + kStride) % kWindow;
  const int first = sel * kWindow;
  const long long out_row = base + (r0 + r) * row_stride;
#pragma unroll
  for (int i = 0; i < HD / kWindow; ++i) {
    const int d = j + kWindow * i;
    float a_dq = 0.f, a_dk = 0.f, a_dv = 0.f, b_dq = 0.f, b_dk = 0.f, b_dv = 0.f;
#pragma unroll
    for (int c = 0; c < kWindow; ++c) {
      a_dq = fmaf(sDLa[r][c], sKa[c][d], a_dq);
      a_dk = fmaf(sDLa[c][r], sQa[c][d], a_dk);
      a_dv = fmaf(sWa[c][r], sG[kStride + c][d], a_dv);
      b_dq = fmaf(sDLb[sel][li][c], sKb[first + c][d], b_dq);
      b_dk = fmaf(sDLb[sel][c][li], sQb[first + c][d], b_dk);
      b_dv = fmaf(sWb[sel][c][li], sG[first + c][d], b_dv);
    }
    dqa[out_row + d] = a2m::from_float<T>(a_dq * scale);
    dka[out_row + d] = a2m::from_float<T>(a_dk);
    dqb[out_row + d] = a2m::from_float<T>(b_dq * scale);
    dkb[out_row + d] = a2m::from_float<T>(b_dk);
    dv[out_row + d] = a2m::from_float<T>(a_dv + b_dv);
  }
}

struct Args {
  const void *qa, *ka, *qb, *kb, *v, *g, *bits_a, *bits_b, *seed;
  void *dqa, *dka, *dqb, *dkb, *dv;
  int B, P, H, threshold;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int MASK>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.P / kWindow, a.H, a.B);
  local_two_phase_grads_kernel<T, HD, MASK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.qa), static_cast<const T*>(a.ka), static_cast<const T*>(a.qb),
      static_cast<const T*>(a.kb), static_cast<const T*>(a.v), static_cast<const T*>(a.g),
      static_cast<const uint8_t*>(a.bits_a), static_cast<const uint8_t*>(a.bits_b),
      static_cast<const int*>(a.seed), static_cast<T*>(a.dqa), static_cast<T*>(a.dka),
      static_cast<T*>(a.dqb), static_cast<T*>(a.dkb), static_cast<T*>(a.dv), a.P, a.H,
      a.threshold, a.scale);
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

// qa, ka, qb, kb, v, g and the five outputs: contiguous (B, P, H*hd) device
// buffers of one dtype, P a multiple of 16.  Either bits_a and bits_b
// (contiguous (B, H, P, P) uint8, one per phase) or seed ((2,) int32 in
// device memory) may be given, with threshold in (0, 256); all null: no
// dropout.  Returns the cudaError_t of the launch (0 on success).
extern "C" int a2m_local_two_phase_grads(const void* qa, const void* ka, const void* qb,
                                         const void* kb, const void* v, const void* g,
                                         const void* bits_a, const void* bits_b,
                                         const void* seed, void* dqa, void* dka, void* dqb,
                                         void* dkb, void* dv, int B, int P, int H, int hd,
                                         int threshold, float scale, int dtype, void* stream) {
  if (P % kWindow != 0) return cudaErrorInvalidValue;
  const bool with_bits = bits_a != nullptr || bits_b != nullptr;
  const bool dropout = with_bits || seed != nullptr;
  if ((with_bits && (bits_a == nullptr || bits_b == nullptr || seed != nullptr)) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  const Args a = {qa, ka, qb, kb, v, g, bits_a, bits_b, seed, dqa, dka, dqb, dkb, dv, B, P, H,
                  threshold, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
