// Multi-head attention over the head-major (G, H, S, hd) layout: the C entry
// of TPU kernel 3, audio_to_midi_tpu/ops/pallas_attention.py fused_attention
// (:219; _fused_attention_impl :170 -> pallas_call :190, body
// _attention_kernel :36-64).  Per (sample, head): logits = (q * 1/sqrt(hd),
// scaled in q's dtype) . k^T in fp32, columns at or past S never count, with
// block > 0 a column outside the row's block is -1e30; fp32 softmax; weights
// . v in fp32, the weights rounded to the dtype first, as the TPU kernel's
// weights.astype(v.dtype) (:63).
//
// A contiguous (G, H, S, hd) tensor is the natural layout (G*H, S, 1*hd) of
// TPU kernel 1, so this entry launches kernel 1's tensor-core forward
// (global_attention_fwd.cuh) on G*H samples of one head with valid_len = S;
// that file says what bounds it on this card and what its design does.  The
// TPU kernel pads S to 128 and packs several heads into one cell, kept apart
// by a block-diagonal mask: its VMEM layout, not its function.  The samples
// lie on the grid's z dimension: G*H at most 65,535 (the wrapper raises
// ValueError past that).  The JAX package reaches this kernel through
// fused_attention only (tests), and so does the port.

#include "common.cuh"
#include "global_attention_fwd.cuh"

// q, k, v, out: contiguous (G, H, S, hd) device buffers of one dtype, each
// 16-byte aligned; block >= 0 (0: no block mask).  Returns the cudaError_t of
// the launch.
extern "C" int a2m_head_major_attention(const void* q, const void* k, const void* v, void* out,
                                        int G, int H, int S, int hd, int block, float scale,
                                        int dtype, void* stream) {
  const long long samples = static_cast<long long>(G) * H;
  if (S <= 0 || block < 0 || samples <= 0 || samples > 65535) return cudaErrorInvalidValue;
  const a2m::GlobalForwardArgs a = {q, k, v, nullptr, nullptr, out, static_cast<int>(samples),
                                    S, 1, S, block, 0, scale, static_cast<cudaStream_t>(stream)};
  return a2m::global_attention_forward(a, hd, dtype);
}
