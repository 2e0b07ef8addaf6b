// The C entry of the global attention backward, TPU kernels 9 and 16
// (audio_to_midi_tpu/ops/pallas_attention.py nhd_grads :1104 and
// nhd_grads_prng :1833): checks its arguments and hands them to the launches
// of their dtype.  The kernels, what bounds them and their design:
// global_attention_bwd.cuh; the instantiations: global_attention_bwd_f32.cu
// and global_attention_bwd_bf16.cu, which compile in parallel.

#include <stdint.h>

#include <initializer_list>

#include "global_attention_bwd.cuh"

// q, k, v, g, dq, dk, dv: contiguous (G, S, H*hd) device buffers of one
// dtype, each 16-byte aligned (the tiles are copied 16 bytes at a time;
// misaligned: cudaErrorMisalignedAddress, nothing launched).  At most one of
// bits (contiguous (G, H, S, S) uint8) and seed ((2,) int32 in device
// memory) is given, with threshold in (0, 256); both null: no dropout.
// stats: fp32 scratch of G*H*3*S elements.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int a2m_global_attention_grads(const void* q, const void* k, const void* v,
                                          const void* g, const void* bits, const void* seed,
                                          void* dq, void* dk, void* dv, void* stats, int G,
                                          int S, int H, int hd, int valid_len, int block,
                                          int threshold, float scale, int dtype,
                                          void* stream) {
  const bool dropout = bits != nullptr || seed != nullptr;
  if ((bits != nullptr && seed != nullptr) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, g, static_cast<const void*>(dq), static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (!a2m::aligned16(p)) return cudaErrorMisalignedAddress;
  const a2m::GlobalGradsArgs a = {q, k, v, g, bits, seed, dq, dk, dv, stats, G, S, H,
                                  valid_len, block, threshold, scale,
                                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return a2m::global_attention_grads_f32(a, hd);
    case a2m::kBFloat16: return a2m::global_attention_grads_bf16(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
