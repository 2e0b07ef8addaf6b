// The C entry of the global attention forward over the natural (G, S, H*hd)
// layout, TPU kernels 1, 4 and 15 of audio_to_midi_tpu/ops/pallas_attention.py:
// fused_attention_nhd (:140) without a mask source, fused_attention_nhd_dropout
// (:381) with precomputed uint8 bits, _nhd_drop_prng_impl (:1783) with Philox
// bytes drawn in the kernel from a seed.  All three launch the tensor-core
// forward, whose header (global_attention_fwd.cuh) says what it computes,
// what bounds it and what its design does.  This file holds no kernel body:
// only this entry and a2m_error_string, with which the Python side names
// the error code of any entry.

#include "global_attention_fwd.cuh"

// q, k, v, out: contiguous (G, S, H*hd) device buffers of one dtype, each
// 16-byte aligned (else cudaErrorMisalignedAddress, nothing launched).  At
// most one of bits (contiguous (G, H, S, S) uint8, any alignment) and seed
// ((2,) int32 in device memory) is given, with threshold in (0, 256); both
// null: no dropout.  Returns the cudaError_t of the launch (0 on success).
extern "C" int a2m_global_attention(const void* q, const void* k, const void* v,
                                    const void* bits, const void* seed, void* out, int G, int S,
                                    int H, int hd, int valid_len, int block, int threshold,
                                    float scale, int dtype, void* stream) {
  const a2m::GlobalForwardArgs a = {q, k, v, bits, seed, out, G, S, H, valid_len, block,
                                    threshold, scale, static_cast<cudaStream_t>(stream)};
  return a2m::global_attention_forward(a, hd, dtype);
}

extern "C" const char* a2m_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
