// The whole attention block of a layer, x (B, P, D) pre-normed -> (B, P, D):
// q / kv / k / v products, RoPE, attention (windowed or global), the overlap
// average of the windows, the bias-free out-projection.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_attention_layer
// (:1391, kernel _attn_block_kernel :1282), attention_impl="pallas_block".
// The TPU kernel runs one sample per grid cell.  In its local mode it
// re-windows the P padded rows into P/8 - 1 windows of 16 (496 rows for
// P = 256, padded to 512 for its tiles) with positions restarting in every
// window; since the products are row-wise, window w's rows are padded rows
// [8w, 8w + 16), and the windowed attention is the two-phase computation on
// the P rows themselves.  So this kernel projects the P rows once and never
// builds the windowed copy; the local core reads the caller's windowed RoPE
// table at row 16 w + position.  Global mode: P = S rows, columns < valid_len,
// absolute positions.  No LayerNorm, no residual: the caller adds them and
// crops the local output to its first S rows.
//
// What bounds it on the card: the products, 2 P D (H hd + C) + 4 P C H hd +
// 2 P H hd D operations a sample (~92 MFLOP at the default widths), plus the
// attention's (local: ~4 MFLOP; global: ~67), against 2 P D elements in
// and out.  The design: four product launches and the attention (local: one
// launch; global: a RoPE pass and the core) into a workspace, then the
// out-projection; the products and the global core on the tensor cores
// (fused_layer.cuh, fused_layer_impl.cuh).

#include "fused_layer.cuh"

namespace a2m {
namespace fl_block {

using namespace a2m::fl;

struct Args {
  const void *x, *wq, *wkv, *wk, *wv, *wo;
  const float *cos, *sin;
  void *out, *workspace;
  Geometry g;
  int valid_len, window, table_rows;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  Carver ws(need != nullptr ? nullptr : a.workspace);
  const AttnBuffers<T> b = carve_attn<T>(ws, a.g, false);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }
  const T* x = static_cast<const T*>(a.x);
  using L = Layer<T>;
  cudaError_t err = L::projections(x, static_cast<const T*>(a.wq), static_cast<const T*>(a.wkv),
                                   static_cast<const T*>(a.wk), static_cast<const T*>(a.wv), b,
                                   a.g, a.stream);
  if (err != cudaSuccess) return err;
  const float* tables[2] = {a.cos, a.sin};
  err = a.window > 0
            ? L::local_core(b, tables, kTablesByWindow, a.g, 0, a.g.P, a.scale, a.stream)
            : L::global_core(b, a.cos, a.sin, a.g, 0, a.valid_len, a.scale, a.stream);
  if (err != cudaSuccess) return err;
  return L::out_projection(b.attn, static_cast<const T*>(a.wo), static_cast<T*>(a.out), a.g,
                           a.stream);
}

static bool valid(const Args& a) {
  const Geometry& g = a.g;
  if (g.B < 1 || g.P < 1 || g.D < 1 || g.H < 1 || g.C < 1) return false;
  const long long widest = g.D > g.width() ? g.D : g.width();
  if (g.rows() * widest > 0x7fffffffLL) return false;
  if (a.window > 0)  // windows of 16 at stride 8: at least one, each row in one or two
    return a.window == kWindow && g.P % kStride == 0 && g.P >= kWindow &&
           a.table_rows >= (g.P / kStride - 1) * kWindow;
  return a.window == 0 && a.valid_len >= 1 && a.valid_len <= g.P && a.table_rows >= g.P;
}

static cudaError_t dispatch(int dtype, const Args& a, size_t* need) {
  if (a.g.hd != 16 && a.g.hd != 32 && a.g.hd != 64 && a.g.hd != 128) return cudaErrorInvalidValue;
  switch (dtype) {
    case a2m::kFloat32: return run<float>(a, need);
    case a2m::kBFloat16: return run<__nv_bfloat16>(a, need);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fl_block
}  // namespace a2m

using namespace a2m::fl_block;

// Bytes of workspace a call of this geometry needs (0: not taken).
extern "C" long long a2m_attention_block_workspace(int B, int P, int D, int H, int hd, int C,
                                                   int dtype) {
  Args a = {};
  a.g = {B, P, D, H, hd, C, 0};
  a.valid_len = P;
  a.table_rows = P;
  size_t need = 0;
  if (!valid(a) || dispatch(dtype, a, &need) != cudaSuccess) return 0;
  return static_cast<long long>(need);
}

// x, out: contiguous (B, P, D) of one dtype, out distinct from x; wq (D, H hd),
// wkv (D, C), wk, wv (C, H hd), wo (H hd, D) in that dtype; cos, sin:
// (table_rows, hd / 2) fp32 -- window 16: the windowed table (row 16 w + pos),
// window 0: one row per sequence row.  scale: 1/sqrt(hd) as a value of the
// dtype.  Returns the cudaError_t of the first failed launch (0 on success).
extern "C" int a2m_attention_block(const void* x, const void* wq, const void* wkv, const void* wk,
                                   const void* wv, const void* wo, const void* cos,
                                   const void* sin, void* out, void* workspace, int B, int P,
                                   int D, int H, int hd, int C, int valid_len, int window,
                                   int table_rows, float scale, int dtype, void* stream) {
  Args a = {x, wq, wkv, wk, wv, wo, static_cast<const float*>(cos),
            static_cast<const float*>(sin), out, workspace, {B, P, D, H, hd, C, 0},
            valid_len, window, table_rows, scale, static_cast<cudaStream_t>(stream)};
  if (workspace == nullptr || out == x || !valid(a)) return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}
