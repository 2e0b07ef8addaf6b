// One fused attention sublayer, x (B, P, D) in local-padded coordinates ->
// (B, P, D): pre-LayerNorm (rows outside [pad_l, pad_l + S) masked to zero),
// q / kv / k / v products, RoPE, attention, out-projection, masked residual.
//
// Replaces audio_to_midi_tpu/ops/pallas_sublayer.py _call (:133, the
// pallas_call at :139) with its two bodies: fused_local_sublayer (:149,
// _local_sublayer_kernel :32) and fused_global_sublayer (:164,
// _global_sublayer_kernel :88); attention_impl="pallas_fused", whose FFNs
// stay plain PyTorch as they stay XLA in the JAX package.
//   * local: the two-phase windows (P % 16 == 0; per-padded-row phase
//     tables cos_a, sin_a, cos_b, sin_b); the first S rows of the average are
//     re-stored at rows pad_l + i (the reference's padded-coordinate quirk);
//   * global: columns valid in [pad_l, pad_l + S), the table cos_g, sin_g
//     (cos 1, sin 0 on the first pad_l rows, positions 0, 1, ... from pad_l).
//
// What bounds it on the card: the products (~92 MFLOP a sample at the
// default widths) and, global, the logits (~67 MFLOP), against 2 P D
// elements in and out: at 16 windows ~0.0016 / 0.0026 ms at the bf16
// tensor-core peak.  The TPU kernel keeps a cell of samples in fast memory;
// here a sublayer is seven launches into a workspace (eight for the global
// one, with its RoPE pass; fused_layer.cuh), the kernel boundary the barrier
// between the row-wise steps and the attention: the products and the global
// core on the tensor cores, LayerNorm and the local core as fp32 loops over
// bytes (fused_layer_impl.cuh).

#include "fused_layer.cuh"

namespace a2m {
namespace fl_sub {

using namespace a2m::fl;

struct Args {
  const void *x;
  const float* ln;
  const void *wq, *wkv, *wk, *wv, *wo;
  const float* tables[4];
  void *out, *workspace;
  Geometry g;
  int S, pad_l;
  bool local;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  Carver ws(need != nullptr ? nullptr : a.workspace);
  const AttnBuffers<T> b = carve_attn<T>(ws, a.g, true);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }
  return Layer<T>::attention_sublayer(
      static_cast<const T*>(a.x), a.ln, static_cast<const T*>(a.wq),
      static_cast<const T*>(a.wkv), static_cast<const T*>(a.wk), static_cast<const T*>(a.wv),
      static_cast<const T*>(a.wo), a.tables, static_cast<T*>(a.out), b, a.g, a.S, a.pad_l,
      a.local, a.scale, a.stream);
}

static bool valid(const Args& a) {
  const Geometry& g = a.g;
  if (g.B < 1 || g.P < kWindow || g.P % kWindow != 0 || g.D < 1 || g.H < 1 || g.C < 1)
    return false;
  const long long widest = g.D > g.width() ? g.D : g.width();
  return g.rows() * widest <= 0x7fffffffLL && a.S >= 1 && a.pad_l >= 0 && a.pad_l + a.S <= g.P;
}

static cudaError_t dispatch(int dtype, const Args& a, size_t* need) {
  if (a.g.hd != 16 && a.g.hd != 32 && a.g.hd != 64 && a.g.hd != 128) return cudaErrorInvalidValue;
  switch (dtype) {
    case a2m::kFloat32: return run<float>(a, need);
    case a2m::kBFloat16: return run<__nv_bfloat16>(a, need);
    default: return cudaErrorInvalidValue;
  }
}

static int call(const void* x, const void* ln, const void* wq, const void* wkv, const void* wk,
                const void* wv, const void* wo, const void* const* tables, int n_tables,
                void* out, void* workspace, int B, int P, int D, int H, int hd, int C, int S,
                int pad_l, bool local, float scale, int dtype, void* stream) {
  Args a = {};
  a.x = x;
  a.ln = static_cast<const float*>(ln);
  a.wq = wq;
  a.wkv = wkv;
  a.wk = wk;
  a.wv = wv;
  a.wo = wo;
  for (int i = 0; i < n_tables; ++i) a.tables[i] = static_cast<const float*>(tables[i]);
  a.out = out;
  a.workspace = workspace;
  a.g = {B, P, D, H, hd, C, 0};
  a.S = S;
  a.pad_l = pad_l;
  a.local = local;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (workspace == nullptr || out == x || !valid(a)) return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}

}  // namespace fl_sub
}  // namespace a2m

using namespace a2m::fl_sub;

// Bytes of workspace a call of this geometry needs (0: not taken).
extern "C" long long a2m_fused_sublayer_workspace(int B, int P, int D, int H, int hd, int C,
                                                  int dtype) {
  Args a = {};
  a.g = {B, P, D, H, hd, C, 0};
  a.S = P;
  size_t need = 0;
  if (!valid(a) || dispatch(dtype, a, &need) != cudaSuccess) return 0;
  return static_cast<long long>(need);
}

// x, out: contiguous (B, P, D) of one dtype, out distinct from x, P a
// multiple of 16; ln (2, D) fp32 (scale, bias); wq (D, H hd), wkv (D, C),
// wk, wv (C, H hd), wo (H hd, D) in the dtype; cos_a, sin_a, cos_b, sin_b:
// (P, hd / 2) fp32.  scale: 1/sqrt(hd) as a value of the dtype.  Returns the
// cudaError_t of the first failed launch (0 on success).
extern "C" int a2m_fused_local_sublayer(const void* x, const void* ln, const void* wq,
                                        const void* wkv, const void* wk, const void* wv,
                                        const void* wo, const void* cos_a, const void* sin_a,
                                        const void* cos_b, const void* sin_b, void* out,
                                        void* workspace, int B, int P, int D, int H, int hd,
                                        int C, int S, int pad_l, float scale, int dtype,
                                        void* stream) {
  const void* tables[4] = {cos_a, sin_a, cos_b, sin_b};
  return call(x, ln, wq, wkv, wk, wv, wo, tables, 4, out, workspace, B, P, D, H, hd, C, S, pad_l,
              true, scale, dtype, stream);
}

// As a2m_fused_local_sublayer, with the global table cos_g, sin_g (P, hd / 2).
extern "C" int a2m_fused_global_sublayer(const void* x, const void* ln, const void* wq,
                                         const void* wkv, const void* wk, const void* wv,
                                         const void* wo, const void* cos_g, const void* sin_g,
                                         void* out, void* workspace, int B, int P, int D, int H,
                                         int hd, int C, int S, int pad_l, float scale, int dtype,
                                         void* stream) {
  const void* tables[2] = {cos_g, sin_g};
  return call(x, ln, wq, wkv, wk, wv, wo, tables, 2, out, workspace, B, P, D, H, hd, C, S, pad_l,
              false, scale, dtype, stream);
}
