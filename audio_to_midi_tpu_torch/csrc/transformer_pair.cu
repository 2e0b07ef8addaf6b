// A whole alternating transformer pair, x (B, P, D) in local-padded
// coordinates -> (B, P, D): local attention sublayer, its GLU FFN, global
// attention sublayer, its GLU FFN, each pre-LN with a residual whose branch
// is masked to the rows [pad_l, pad_l + S).
//
// Replaces audio_to_midi_tpu/ops/pallas_pair.py fused_transformer_pair
// (:229, kernel _pair_kernel :107, the pallas_call at :249),
// attention_impl="pallas_pair".  The TPU kernel keeps a cell of samples and
// the pair's 2.3 MB of weights in fast memory for all four sublayers.  Here
// the pair is a sequence of launches inside this one entry: the two attention
// sublayers of fused_sublayer.cu and two FFN sublayers (LayerNorm on every
// row, the product to 2I with its bias, the GLU gate split at the h1 width of
// its own side, the product back with its bias and the masked residual),
// through a workspace; the kernel boundary is the barrier between row-wise
// steps and attention.
//
// What bounds it on the card: ~660 MFLOP a sample at the default widths
// (~10.6 GFLOP at 16 windows, ~9.4 of them in the 14 products: ~0.011 ms at
// the bf16 tensor-core peak, ~0.064 ms as 3xTF32 in f32), against 2 P D
// elements in and out.  Every product and the global attention core run on
// the tensor cores (fused_layer_impl.cuh); at 16 windows the pair's 23
// launches are short enough that their latency and tails, not a roofline,
// set its time.

#include "fused_layer.cuh"

namespace a2m {
namespace fl_pair {

using namespace a2m::fl;

constexpr int kWeights = 22;  // 11 a side, in ops/pallas_pair.py pair_weights order
constexpr int kTables = 6;

struct Args {
  const void* x;
  const void* const* w;
  const float* const* t;
  void *out, *workspace;
  Geometry g;
  int S, pad_l;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  const size_t R = static_cast<size_t>(a.g.rows());
  Carver ws(need != nullptr ? nullptr : a.workspace);
  const AttnBuffers<T> b = carve_attn<T>(ws, a.g, true);
  T* h1 = ws.take<T>(R * 2 * a.g.I);
  T* gate = ws.take<T>(R * a.g.I);
  T* xa = ws.take<T>(R * a.g.D);
  T* xb = ws.take<T>(R * a.g.D);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }
  auto w = [&](int i) { return static_cast<const T*>(a.w[i]); };
  auto ln = [&](int i) { return static_cast<const float*>(a.w[i]); };
  const float* local_tables[4] = {a.t[0], a.t[1], a.t[2], a.t[3]};
  const float* global_tables[2] = {a.t[4], a.t[5]};
  using L = Layer<T>;
  cudaError_t err = L::attention_sublayer(static_cast<const T*>(a.x), ln(0), w(1), w(2), w(3),
                                          w(4), w(5), local_tables, xa, b, a.g, a.S, a.pad_l,
                                          true, a.scale, a.stream);
  if (err != cudaSuccess) return err;
  err = L::ffn_sublayer(xa, ln(6), w(7), w(8), w(9), w(10), xb, b.normed, h1, gate, a.g, a.S,
                        a.pad_l, a.stream);
  if (err != cudaSuccess) return err;
  err = L::attention_sublayer(xb, ln(11), w(12), w(13), w(14), w(15), w(16), global_tables, xa,
                              b, a.g, a.S, a.pad_l, false, a.scale, a.stream);
  if (err != cudaSuccess) return err;
  return L::ffn_sublayer(xa, ln(17), w(18), w(19), w(20), w(21), static_cast<T*>(a.out),
                         b.normed, h1, gate, a.g, a.S, a.pad_l, a.stream);
}

static bool valid(const Args& a) {
  const Geometry& g = a.g;
  if (g.B < 1 || g.P < kWindow || g.P % kWindow != 0 || g.D < 1 || g.H < 1 || g.C < 1 ||
      g.I < 1)
    return false;
  long long widest = g.D > g.width() ? g.D : g.width();
  widest = widest > 2LL * g.I ? widest : 2LL * g.I;
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

}  // namespace fl_pair
}  // namespace a2m

using namespace a2m::fl_pair;

// Bytes of workspace a call of this geometry needs (0: not taken).
extern "C" long long a2m_transformer_pair_workspace(int B, int P, int D, int H, int hd, int C,
                                                    int I, int dtype) {
  Args a = {};
  a.g = {B, P, D, H, hd, C, I};
  a.S = P;
  size_t need = 0;
  if (!valid(a) || dispatch(dtype, a, &need) != cudaSuccess) return 0;
  return static_cast<long long>(need);
}

// x, out: contiguous (B, P, D) of one dtype, out distinct from x, P a
// multiple of 16.  weights: the 22 pointers of ops/pallas_pair.py
// pair_weights, local then global: ln1 (2, D) fp32, wq (D, H hd), wkv (D, C),
// wk, wv (C, H hd), wo (H hd, D), ln2 (2, D) fp32, w1 (D, 2I), b1 (1, 2I),
// w2 (I, D), b2 (1, D), all but the LayerNorms in the dtype.  tables:
// cos_a, sin_a, cos_b, sin_b, cos_g, sin_g, each (P, hd / 2) fp32.  scale:
// 1/sqrt(hd) as a value of the dtype.  Returns the cudaError_t of the first
// failed launch (0 on success).
extern "C" int a2m_transformer_pair(const void* x, const void* const* weights,
                                    const void* const* tables, void* out, void* workspace, int B,
                                    int P, int D, int H, int hd, int C, int I, int S, int pad_l,
                                    float scale, int dtype, void* stream) {
  Args a = {};
  a.x = x;
  a.w = weights;
  a.t = reinterpret_cast<const float* const*>(tables);
  a.out = out;
  a.workspace = workspace;
  a.g = {B, P, D, H, hd, C, I};
  a.S = S;
  a.pad_l = pad_l;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (workspace == nullptr || weights == nullptr || tables == nullptr || out == x || !valid(a))
    return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}
