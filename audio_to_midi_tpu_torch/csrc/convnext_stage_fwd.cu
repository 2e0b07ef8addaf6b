// Forward of all blocks of a ConvNeXt stage, x (B, L, C) -> (B, L, C).
//
// Replaces audio_to_midi_tpu/ops/pallas_convnext.py fused_convnext_stage
// (:131, kernel _stage_kernel, :31-94).  Per block: depthwise conv k=7 SAME
// (fp32, not rounded) -> LayerNorm in fp32, rounded to the storage type ->
// 1x1 to H with the bias added in fp32 -> GELU(tanh), rounded -> 1x1 back
// with the bias added in fp32 -> times gamma in fp32, rounded -> added to
// the block's input in the storage type.
//
// What bounds it on the card: per block 4 R C H operations for R = B L rows
// (stage 5 at 16 windows: 8,000 rows, 128 -> 256: 1.05 GFLOP a block) over
// rows of 2 R C bytes in and out: above the bf16 ridge only on tensor
// cores, on the fp32 cores it is bound by their FMA rate.  The TPU kernel
// keeps a cell of samples and all weights in fast memory for the whole
// stage and pads L to a multiple of 8; neither is needed here.  Design:
// three launches per block inside one entry (see convnext_stage.cuh for
// why a block is the unit) --
//   1. conv + LayerNorm, one warp per row, reading the 7 taps from global
//      memory (the rows are hot in L2), -> t (R, C);
//   2. t . pw1 with GELU in the epilogue -> z (R, H);
//   3. z . pw2 with bias, gamma and the residual in the epilogue -> the
//      block's output, written into `out` (the first block reads x, the
//      later ones update `out` in place: each thread reads and writes only
//      its own elements).
// t and z are scratch of one block, reused by the next; rows are bounds-
// checked, so any L works.

#include "convnext_stage.cuh"

namespace a2m {
namespace cnx_fwd {

using namespace a2m::cnx;

template <typename T>
struct GeluEpilogue {  // z = round(gelu(acc + b))
  const T* bias;
  T* z;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    const float h = acc + to_float(bias[n]);
    z[static_cast<size_t>(m) * ld + n] = from_float<T>(gelu_from_tanh(h, gelu_tanh_term(h)));
  }
};

template <typename T>
struct ResidualEpilogue {  // out = x + round((acc + b) * gamma)
  const T* bias;
  const T* gamma;
  const T* x;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    const size_t at = static_cast<size_t>(m) * ld + n;
    const float branch = round_to<T>((acc + to_float(bias[n])) * to_float(gamma[n]));
    out[at] = from_float<T>(to_float(x[at]) + branch);
  }
};

struct Args {
  const void *x, *dw, *dwb, *ln, *pw1, *pw1b, *pw2, *pw2b, *gamma;
  void *out, *workspace;
  int depth, B, L, C, H;
  cudaStream_t stream;
};

// With `need` the workspace bytes go there and nothing launches.
template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  const int R = a.B * a.L, C = a.C, H = a.H;
  Carver ws(need != nullptr ? nullptr : a.workspace);
  T* t = ws.take<T>(static_cast<size_t>(R) * C);
  T* z = ws.take<T>(static_cast<size_t>(R) * H);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }

  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (int d = 0; d < a.depth; ++d) {
    const T* dw = static_cast<const T*>(a.dw) + static_cast<size_t>(d) * kTaps * C;
    const T* dwb = static_cast<const T*>(a.dwb) + static_cast<size_t>(d) * C;
    const float* ln = static_cast<const float*>(a.ln) + static_cast<size_t>(d) * 2 * C;
    const T* pw1 = static_cast<const T*>(a.pw1) + static_cast<size_t>(d) * C * H;
    const T* pw1b = static_cast<const T*>(a.pw1b) + static_cast<size_t>(d) * H;
    const T* pw2 = static_cast<const T*>(a.pw2) + static_cast<size_t>(d) * H * C;
    const T* pw2b = static_cast<const T*>(a.pw2b) + static_cast<size_t>(d) * C;
    const T* gamma = static_cast<const T*>(a.gamma) + static_cast<size_t>(d) * C;
    const T* cur = d == 0 ? x : out;

    cudaError_t err = launch_conv_ln<T, false>(cur, dw, dwb, ln, t, R, a.L, C, a.stream);
    if (err != cudaSuccess) return err;
    // t (R, C) . pw1 (C, H): A along its rows, B down its columns.
    err = launch_gemm<T, true, false>(t, pw1, R, H, C, C, H, C, 1,
                                      GeluEpilogue<T>{pw1b, z, H}, a.stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm<T, true, false>(z, pw2, R, C, H, H, C, H, 1,
                                      ResidualEpilogue<T>{pw2b, gamma, cur, out, C}, a.stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

static bool valid(const Args& a) {
  return a.depth >= 1 && a.B >= 1 && a.L >= 1 && a.C >= 1 && a.H >= 1 &&
         static_cast<long long>(a.B) * a.L <= 0x7fffffffLL / (a.C > a.H ? a.C : a.H) &&
         static_cast<size_t>(kRowWarps) * a.C * sizeof(float) <= kMaxSharedBytes;
}

static cudaError_t dispatch(int dtype, const Args& a, size_t* need) {
  switch (dtype) {
    case a2m::kFloat32: return run<float>(a, need);
    case a2m::kBFloat16: return run<__nv_bfloat16>(a, need);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cnx_fwd
}  // namespace a2m

using namespace a2m::cnx_fwd;

// Bytes of workspace a call with this geometry needs (0: not taken).
extern "C" long long a2m_convnext_stage_fwd_workspace(int B, int L, int C, int H, int dtype) {
  Args a = {};
  a.depth = 1;
  a.B = B;
  a.L = L;
  a.C = C;
  a.H = H;
  size_t need = 0;
  if (!valid(a) || dispatch(dtype, a, &need) != cudaSuccess) return 0;
  return static_cast<long long>(need);
}

// x, out: contiguous (B, L, C) device buffers of one dtype, out distinct
// from x.  Weights, stacked over the stage's blocks: dw (depth, 7, C), dwb
// (depth, 1, C), ln (depth, 2, C) fp32, pw1 (depth, C, H), pw1b (depth, 1,
// H), pw2 (depth, H, C), pw2b, gamma (depth, 1, C).  workspace: at least
// a2m_convnext_stage_fwd_workspace bytes.  Returns the cudaError_t of the
// first failed launch (0 on success).
extern "C" int a2m_convnext_stage_fwd(const void* x, const void* dw, const void* dwb,
                                      const void* ln, const void* pw1, const void* pw1b,
                                      const void* pw2, const void* pw2b, const void* gamma,
                                      void* out, void* workspace, int depth, int B, int L, int C,
                                      int H, int K, int dtype, void* stream) {
  const Args a = {x, dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma, out, workspace,
                  depth, B, L, C, H, static_cast<cudaStream_t>(stream)};
  if (K != a2m::cnx::kTaps || workspace == nullptr || out == x || !valid(a))
    return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}
