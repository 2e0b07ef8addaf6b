// The C entry of the two-phase local attention forward, TPU kernels 2, 5 and
// 12 (audio_to_midi_tpu/ops/pallas_attention.py fused_local_two_phase :608,
// fused_local_two_phase_dropout :697 and _two_phase_drop_prng_impl :1622):
// checks its arguments and hands them to the launches of their dtype.  The
// kernel, what bounds it and its design: local_attention_fwd.cuh; the
// instantiations: local_attention_fwd_f32.cu and local_attention_fwd_bf16.cu,
// which compile in parallel.

#include <stdint.h>

#include <initializer_list>

#include "local_attention_fwd.cuh"

// qa, ka, qb, kb, v, out: contiguous (B, P, H*hd) device buffers of one
// dtype, P a multiple of 16, each 16-byte aligned (the rows are copied and
// the output stored 16 bytes at a time; misaligned:
// cudaErrorMisalignedAddress, nothing launched).  Either bits_a and bits_b
// (contiguous (B, H, P, P) uint8, one per phase, 16-byte aligned) or seed
// ((2,) int32 in device memory) may be given, with threshold in (0, 256);
// all null: no dropout.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int a2m_local_two_phase(const void* qa, const void* ka, const void* qb,
                                   const void* kb, const void* v, const void* bits_a,
                                   const void* bits_b, const void* seed, void* out, int B,
                                   int P, int H, int hd, int threshold, float scale, int dtype,
                                   void* stream) {
  if (P % 16 != 0) return cudaErrorInvalidValue;
  const bool with_bits = bits_a != nullptr || bits_b != nullptr;
  const bool dropout = with_bits || seed != nullptr;
  if ((with_bits && (bits_a == nullptr || bits_b == nullptr || seed != nullptr)) ||
      (dropout && (threshold <= 0 || threshold >= 256)))
    return cudaErrorInvalidValue;
  for (const void* p : {qa, ka, qb, kb, v, static_cast<const void*>(out)})
    if (!a2m::aligned16(p)) return cudaErrorMisalignedAddress;
  if (with_bits && (!a2m::aligned16(bits_a) || !a2m::aligned16(bits_b)))
    return cudaErrorMisalignedAddress;
  const a2m::LocalArgs a = {qa, ka, qb, kb, v, bits_a, bits_b, seed, out, B, P, H, threshold,
                            scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return a2m::local_two_phase_f32(a, hd);
    case a2m::kBFloat16: return a2m::local_two_phase_bf16(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
