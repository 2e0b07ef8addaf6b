// Global attention over the natural (G, S, H*hd) layout with the
// halves-layout RoPE of q and k inside: the C entry of TPU kernel 10,
// audio_to_midi_tpu/ops/pallas_attention.py fused_rope_attention (:1229 ->
// pallas_call :1243, body _attention_kernel_nhd_rope :1154).  q and k
// arrive unroped.  Per head, in the order of the TPU body (:1177-1190):
// each element is rotated in fp32 by its row of the cos / sin tables
// ((S, hd/2) fp32) and rounded to the dtype, q is then scaled by 1/sqrt(hd)
// in its dtype; logits in fp32, columns at or past S never count, with
// block > 0 a column outside the row's block is -1e30; fp32 softmax; the
// weights rounded to v's dtype before their product with v (:1190).
//
// Two steps on the caller's stream, into a workspace of 2 G S H hd elements:
//   1. q and k are copied into the workspace and RoPE'd there in place by
//      the fused layers' pass (rope_rows_kernel, rope_rows.cuh) with scale 1,
//      so they are rotated and rounded to T, nothing more;
//   2. kernel 1's tensor-core body (global_attention_fwd.cuh) runs on the
//      RoPE'd rows with no mask source, valid_len = S and the caller's
//      block, and scales q in T as it copies its tile.
// So kernel 10 gives kernel 1's bits on q and k RoPE'd by the plain
// rotation, and rounds its weights where kernel 1 does: in bf16 each tile's
// unnormalised weights exp(s - m), before the product with v, as the TPU
// kernel casts its weights.
//
// What bounds it on this card: at the serving shapes (16 windows, S = 250,
// 4 heads x 64) kernel 1's body (its header: bf16 bound by bytes, f32 by
// the 3xTF32 products); the RoPE pass moves q and k three times more (the
// copy's read and write, then the pass's read and write: 16 MB in f32 at 16
// windows, ~5 us at 3.35 TB/s) and reads the tables.  The copy keeps the
// pass the fused layers run, whose SASS stays theirs; a pass that reads q
// and k and writes the workspace would drop one of those round trips.

#include "global_attention_fwd.cuh"
#include "rope_rows.cuh"

namespace {

template <typename T, int HD>
cudaError_t rope_pass(T* q, T* k, const float* cos_table, const float* sin_table, int G, int S,
                      int H, cudaStream_t stream) {
  using a2m::fl::kRowThreads;
  const long long items = static_cast<long long>(G) * S * H * (HD / 2 / a2m::fl::Piece<T>::kVec);
  a2m::fl::rope_rows_kernel<T, HD>
      <<<static_cast<unsigned>((items + kRowThreads - 1) / kRowThreads), kRowThreads, 0,
         stream>>>(q, k, cos_table, sin_table, items, S, H, 1.f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rope_pass_hd(void* workspace, const float* cos_table, const float* sin_table, int G,
                         int S, int H, int hd, cudaStream_t stream) {
  T* q = static_cast<T*>(workspace);
  T* k = q + static_cast<long long>(G) * S * H * hd;
  switch (hd) {
    case 16: return rope_pass<T, 16>(q, k, cos_table, sin_table, G, S, H, stream);
    case 32: return rope_pass<T, 32>(q, k, cos_table, sin_table, G, S, H, stream);
    case 64: return rope_pass<T, 64>(q, k, cos_table, sin_table, G, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (G, S, H*hd) device buffers of one dtype, v and
// out 16-byte aligned (q and k any alignment: they are copied);
// cos_table, sin_table: contiguous (S, hd/2) fp32; workspace: 2 G S H hd
// elements of the dtype, 16-byte aligned, not shared with any other
// buffer; block >= 0 (0: no block mask).  Returns the cudaError_t of the
// first step that failed (0 on success).
extern "C" int a2m_rope_attention(const void* q, const void* k, const void* v,
                                  const void* cos_table, const void* sin_table, void* workspace,
                                  void* out, int G, int S, int H, int hd, int block, float scale,
                                  int dtype, void* stream) {
  if (G <= 0 || S <= 0 || H <= 0 || block < 0 || (hd != 16 && hd != 32 && hd != 64) ||
      (dtype != a2m::kFloat32 && dtype != a2m::kBFloat16))
    return cudaErrorInvalidValue;
  if (!a2m::aligned16(workspace)) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(G) * S * H * hd * (dtype == a2m::kFloat32 ? 4 : 2);
  char* ws = static_cast<char*>(workspace);
  cudaError_t err = cudaMemcpyAsync(ws, q, bytes, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemcpyAsync(ws + bytes, k, bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  const float* c = static_cast<const float*>(cos_table);
  const float* sn = static_cast<const float*>(sin_table);
  err = dtype == a2m::kFloat32 ? rope_pass_hd<float>(ws, c, sn, G, S, H, hd, s)
                               : rope_pass_hd<__nv_bfloat16>(ws, c, sn, G, S, H, hd, s);
  if (err != cudaSuccess) return err;
  const a2m::GlobalForwardArgs a = {ws, ws + bytes, v, nullptr, nullptr, out, G, S, H, S, block,
                                    0, scale, s};
  return a2m::global_attention_forward(a, hd, dtype);
}
