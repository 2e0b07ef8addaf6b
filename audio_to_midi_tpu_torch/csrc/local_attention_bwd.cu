// The C entry of the two-phase local attention backward, TPU kernels 7, 8
// and 13 (audio_to_midi_tpu/ops/pallas_attention.py two_phase_grads :992,
// two_phase_grads_drop :1025 and two_phase_grads_drop_prng :1682): checks
// its arguments and hands them to the launches of their dtype.  The kernel,
// what bounds it and its design: local_attention_bwd.cuh; the
// instantiations: local_attention_bwd_f32.cu and local_attention_bwd_bf16.cu,
// which compile in parallel.

#include <stdint.h>

#include <initializer_list>

#include "local_attention_bwd.cuh"

// qa, ka, qb, kb, v, g and the five outputs: contiguous (B, P, H*hd) device
// buffers of one dtype, P a multiple of 16, each 16-byte aligned (the rows
// are copied and dv stored 16 bytes at a time; misaligned:
// cudaErrorMisalignedAddress, nothing launched).  Either bits_a and bits_b
// (contiguous (B, H, P, P) uint8, one per phase, 16-byte aligned) or seed
// ((2,) int32 in device memory) may be given, with threshold in (0, 256);
// all null: no dropout.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int a2m_local_two_phase_grads(const void* qa, const void* ka, const void* qb,
                                         const void* kb, const void* v, const void* g,
                                         const void* bits_a, const void* bits_b,
                                         const void* seed, void* dqa, void* dka, void* dqb,
                                         void* dkb, void* dv, int B, int P, int H, int hd,
                                         int threshold, float scale, int dtype, void* stream) {
  if (P % 16 != 0) return cudaErrorInvalidValue;
  const bool with_bits = bits_a != nullptr || bits_b != nullptr;
  const bool dropout = with_bits || seed != nullptr;
  if ((with_bits && (bits_a == nullptr || bits_b == nullptr || seed != nullptr)) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  for (const void* p : {qa, ka, qb, kb, v, g, static_cast<const void*>(dqa),
                        static_cast<const void*>(dka), static_cast<const void*>(dqb),
                        static_cast<const void*>(dkb), static_cast<const void*>(dv)})
    if (!a2m::aligned16(p)) return cudaErrorMisalignedAddress;
  if (with_bits && (!a2m::aligned16(bits_a) || !a2m::aligned16(bits_b)))
    return cudaErrorMisalignedAddress;
  const a2m::LocalGradsArgs a = {qa, ka, qb, kb, v, g, bits_a, bits_b, seed, dqa, dka, dqb,
                                 dkb, dv, B, P, H, threshold, scale,
                                 static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return a2m::local_two_phase_grads_f32(a, hd);
    case a2m::kBFloat16: return a2m::local_two_phase_grads_bf16(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
