// The host routines shared by the fused transformer-layer kernels
// (attention_block.cu, fused_sublayer.cu, transformer_pair.cu): the
// geometry of a call, its workspace, and the launches of one dtype
// (Layer<T>), compiled once per dtype in fused_layer_{f32,bf16}.cu from
// fused_layer_impl.cuh, which holds the device code.
//
// The three TPU kernels are one family: row LayerNorm -> q / kv / k / v
// products -> RoPE -> masked multi-head attention -> out-proj (-> masked
// residual, -> GLU FFN).  On the TPU a grid cell keeps a few samples in fast
// memory for the whole sublayer or pair.  Here each of them is a short
// sequence of launches inside one C entry, and the kernel boundary is the
// barrier between the row-wise steps (products, LayerNorm) and the
// attention, which mixes rows.  What passes between launches lives in a
// workspace the entry carves up and whose size it reports.
//
// Roundings (audio_to_midi_tpu/ops/pallas_pair.py:49-104) are the contract
// shared with the plain versions in ops/fused_layer_kernels.py: LayerNorm in
// fp32, eps 1e-5, cast to the dtype; every product accumulates in fp32, adds
// its bias in fp32 and is cast; RoPE in fp32 on the cast values, cast back;
// q times 1/sqrt(hd) in the dtype; fp32 logits and softmax, the weights cast
// to the dtype before the product with v, which is cast again; the overlap
// average in fp32, cast; the residual add in the dtype.
//
// The products and the global attention core run on the tensor cores
// (mma.sync: bf16 m16n8k16, f32 as 3xTF32), the products through
// convnext_gemm.cuh's mma_gemm_kernel with the epilogues of
// fused_layer_impl.cuh; the LayerNorm, the GLU gate and the local core are
// fp32 loops bound by their bytes.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "convnext_stage.cuh"

namespace a2m {
namespace fl {

using cnx::Carver;

constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;

// The RoPE table row of the local core at (window w, row r at position pos):
//   kTablesByRow: table (w even ? A : B) at row r -- the per-padded-row
//   phase tables of kernels 17 and 18;
//   kTablesByWindow: table A at row 16 w + pos -- kernel 11's windowed rows.
enum TableMode : int { kTablesByRow = 0, kTablesByWindow = 1 };

// The geometry of one call.  R = B P rows of width D; the attention has H
// heads of hd (W = H hd), the compressed kv C; the FFN an inner width I.
struct Geometry {
  int B, P, D, H, hd, C, I;
  long long rows() const { return static_cast<long long>(B) * P; }
  int width() const { return H * hd; }
};

// Buffers of one attention sublayer.
template <typename T>
struct AttnBuffers {
  T *normed, *q, *ckv, *k, *v, *attn;
};

template <typename T>
AttnBuffers<T> carve_attn(Carver& ws, const Geometry& g, bool with_normed) {
  const size_t R = static_cast<size_t>(g.rows());
  AttnBuffers<T> b;
  b.normed = with_normed ? ws.take<T>(R * g.D) : nullptr;
  b.q = ws.take<T>(R * g.width());
  b.ckv = ws.take<T>(R * g.C);
  b.k = ws.take<T>(R * g.width());
  b.v = ws.take<T>(R * g.width());
  b.attn = ws.take<T>(R * g.width());
  return b;
}

// The launches of one dtype T; each returns the cudaError_t of its first
// failed launch.
template <typename T>
struct Layer {
  // q, ckv, k, v from the rows `a` (R, D).
  static cudaError_t projections(const T* a, const T* wq, const T* wkv, const T* wk,
                                 const T* wv, const AttnBuffers<T>& b, const Geometry& g,
                                 cudaStream_t stream);
  // The local core (windows of 16 at stride 8) into b.attn: output row r
  // goes to row r + shift when r < limit.  tables: cos_a, sin_a[, cos_b,
  // sin_b] by `mode` (TableMode).
  static cudaError_t local_core(const AttnBuffers<T>& b, const float* const* tables, int mode,
                                const Geometry& g, int shift, int limit, float scale,
                                cudaStream_t stream);
  // The global core into b.attn: every row attends to the columns [lo, hi).
  // Two launches: RoPE (q also scaled) in place on b.q and b.k, the core.
  static cudaError_t global_core(const AttnBuffers<T>& b, const float* cos_t,
                                 const float* sin_t, const Geometry& g, int lo, int hi,
                                 float scale, cudaStream_t stream);
  // out = round(attn . wo), no bias, no residual (kernel 11).
  static cudaError_t out_projection(const T* attn, const T* wo, T* out, const Geometry& g,
                                    cudaStream_t stream);
  // One attention sublayer of kernels 17 and 18 on x (R, D) in padded
  // coordinates, valid rows [pad_l, pad_l + S) of each sample:
  // out = x + mask(attention(mask(LN(x))) . wo).  tables: cos_a, sin_a,
  // cos_b, sin_b (local) or cos_g, sin_g (global), each (P, hd / 2) fp32.
  // scale: 1/sqrt(hd) as a value of T.
  static cudaError_t attention_sublayer(const T* x, const float* ln, const T* wq, const T* wkv,
                                        const T* wk, const T* wv, const T* wo,
                                        const float* const* tables, T* out,
                                        const AttnBuffers<T>& b, const Geometry& g, int S,
                                        int pad_l, bool local, float scale, cudaStream_t stream);
  // The GLU FFN sublayer of kernel 17: out = x + mask(glu(LN(x) . w1 + b1) .
  // w2 + b2); the LayerNorm runs on every row, only the branch is masked.
  static cudaError_t ffn_sublayer(const T* x, const float* ln, const T* w1, const T* b1,
                                  const T* w2, const T* b2, T* out, T* normed, T* h1, T* gate,
                                  const Geometry& g, int S, int pad_l, cudaStream_t stream);
};

extern template struct Layer<float>;
extern template struct Layer<__nv_bfloat16>;

}  // namespace fl
}  // namespace a2m
