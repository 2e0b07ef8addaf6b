// Reduced-width two-phase local attention: window 16, stride 8, with the
// overlap average, in padded coordinates -- the TPU's per-window variant of
// kernel 2 (local_attention_fwd.cuh), attention_impl="pallas_rw".
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_local_two_phase_rw
// (:847; _two_phase_rw_impl :832 -> pallas_call :836, body
// _two_phase_kernel_rw :799 with _blocked_local_core :771 and _roll_up /
// _roll_down :763-768).  The TPU kernel computes each window's (16, 16)
// logit tile instead of kernel 2's masked P x P rows, and makes phase B
// phase A on the rows rolled up by 8, so that one blocked window core serves
// both phases; the rolled last window wraps rows [P - 8, P) and [0, 8), and
// its output, rolled back onto those rows, is zeroed by the band mask.
//
// Here the roll is an offset into shared memory.  A block takes a run of
// kRun windows of one (sample, head) -- output rows [r0, r0 + 16 kRun) --
// and stages, once, the run's qa, ka and qb rows and, for kb and v, the
// run's rows with an 8-row halo on each side (rows r0 - 8 .. r0 + 16 kRun +
// 8).  In those staged rows phase A's window j starts at row 8 + 16 j and
// phase B's (rolled) window j at row 16 j, and the same window core (a row's
// 16 keys on 16 lanes: 16 dots, a shuffle softmax, weights . v) runs on
// both.  A query row computes its phase-B window only inside [8, P - 8), so
// the wrapped window is never computed and no row outside [0, P) is read.
// A phase-B window at the run's edge holds rows of two runs; each run
// computes it for its own rows, so every (row, key) pair of either phase is
// computed once.  As in the TPU body, q is scaled in its dtype, the fp32
// softmax weights are cast to v's dtype before their product with v (as
// kernel 2 does), the products accumulate in fp32, and out = (a + b) / 2
// inside [8, P - 8), a outside.
//
// What bounds it on the card: memory, as kernel 2.  Per (sample, head,
// window) it does 2 x 16 x 16 x hd MACs for the logits and as many for the
// outputs, and it reads the five (B, P, H*hd) inputs and writes the output
// -- ~6 x 16 x 256 x 256 elements at the serving shapes, ~25 MB in f32,
// against ~0.13 GFLOP.  A run of kRun = 2 windows stages 48 rows of kb and
// v for 32 output rows, and keeps 512 threads and ~53 KB of
// shared memory per block (hd 64, f32), three or four blocks to an SM.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;
constexpr int kRun = 2;                    // windows per block
constexpr int kRows = kRun * kWindow;      // output rows per block
constexpr int kHalo = kRows + kWindow;     // staged kb / v rows: the run and 8 on each side
constexpr int kThreads = kRows * kWindow;  // one lane per (query row, key)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kRows * (HD + 1) + kHalo * (HD + 1) + kHalo * HD +
                          2 * kRows * (kWindow + 1));
}

template <int HD>
__device__ __forceinline__ float dot(const float* __restrict__ a, const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// The softmax weight of this lane's key over the 16 aligned lanes that hold
// one query row, rounded to T as the TPU body casts it before weights . v.
// Every lane of the warp must call it (the shuffles take the full mask).
template <typename T>
__device__ __forceinline__ float window_softmax(float logit) {
  float m = logit;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = expf(logit - m);
  float l = e;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  return a2m::round_to<T>(e / l);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
local_two_phase_rw_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
                          const T* __restrict__ qb, const T* __restrict__ kb,
                          const T* __restrict__ v, T* __restrict__ out, int P, int H,
                          float scale) {
  constexpr int kPitch = HD + 1;  // against bank conflicts
  extern __shared__ float smem[];
  float* sQa = smem;                       // [kRows][kPitch]
  float* sKa = sQa + kRows * kPitch;       // [kRows][kPitch]
  float* sQb = sKa + kRows * kPitch;       // [kRows][kPitch]
  float* sKb = sQb + kRows * kPitch;       // [kHalo][kPitch]: staged row s is row r0 - 8 + s
  float* sV = sKb + kHalo * kPitch;        // [kHalo][HD], as sKb
  float* sW = sV + kHalo * HD;             // [phase][kRows][kWindow + 1]: the weights

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, P - r0);     // a multiple of 16: P % 16 == 0
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(blockIdx.z) * P * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const long long off = base + (r0 + r) * row_stride + d;
    sQa[r * kPitch + d] = a2m::scaled_in_dtype(qa[off], scale);
    sKa[r * kPitch + d] = a2m::to_float(ka[off]);
    sQb[r * kPitch + d] = a2m::scaled_in_dtype(qb[off], scale);
  }
  for (int i = tid; i < kHalo * HD; i += kThreads) {
    const int s = i / HD;
    const int d = i % HD;
    const int row = r0 - kStride + s;
    const bool inside = row >= 0 && row < P;
    const long long off = base + row * row_stride + d;
    sKb[s * kPitch + d] = inside ? a2m::to_float(kb[off]) : 0.f;
    sV[s * HD + d] = inside ? a2m::to_float(v[off]) : 0.f;
  }
  __syncthreads();

  const int r = tid / kWindow;  // query row within the run
  const int j = tid % kWindow;  // key within the row's window
  if (r >= rows) return;        // whole warps: rows is a multiple of 16; no barrier follows
  const int row = r0 + r;
  const bool band = row >= kStride && row < P - kStride;
  // Phase A: the run's window r / 16, at staged kb / v row 8 + 16 (r / 16).
  // Phase B: the rolled window that holds row r, at staged row 16 ((r + 8) / 16).
  const int a_first = r / kWindow * kWindow;
  const int b_first = (r + kStride) / kWindow * kWindow;

  const float wa = window_softmax<T>(dot<HD>(sQa + r * kPitch, sKa + (a_first + j) * kPitch));
  const float wb = window_softmax<T>(
      band ? dot<HD>(sQb + r * kPitch, sKb + (b_first + j) * kPitch) : 0.f);
  float* sWa = sW + r * (kWindow + 1);
  float* sWb = sW + (kRows + r) * (kWindow + 1);
  sWa[j] = wa;
  sWb[j] = band ? wb : 0.f;
  __syncwarp();  // a row's weights are written and read by its own 16 lanes

#pragma unroll
  for (int i = 0; i < HD / kWindow; ++i) {
    const int d = j + kWindow * i;
    float oa = 0.f;
    float ob = 0.f;
#pragma unroll
    for (int c = 0; c < kWindow; ++c) {
      oa = fmaf(sWa[c], sV[(kStride + a_first + c) * HD + d], oa);
      ob = fmaf(sWb[c], sV[(b_first + c) * HD + d], ob);
    }
    out[base + row * row_stride + d] = a2m::from_float<T>(band ? (oa + ob) * 0.5f : oa);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qa, const void* ka, const void* qb, const void* kb,
                   const void* v, void* out, int B, int P, int H, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(local_two_phase_rw_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P / kWindow + kRun - 1) / kRun, H, B);
  local_two_phase_rw_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(ka), static_cast<const T*>(qb),
      static_cast<const T*>(kb), static_cast<const T*>(v), static_cast<T*>(out), P, H, scale);
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
// dtype, P a positive multiple of 16.  Returns the cudaError_t of the launch.
extern "C" int a2m_local_two_phase_rw(const void* qa, const void* ka, const void* qb,
                                      const void* kb, const void* v, void* out, int B, int P,
                                      int H, int hd, float scale, int dtype, void* stream) {
  if (P <= 0 || P % kWindow != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(qa, ka, qb, kb, v, out, B, P, H, hd, scale, s);
    case a2m::kBFloat16:
      return dispatch_hd<__nv_bfloat16>(qa, ka, qb, kb, v, out, B, P, H, hd, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
