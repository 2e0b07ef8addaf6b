// The entry into the tensor-core forward of the global attention
// (global_attention_fwd.cu): TPU kernel 1 (a2m_global_attention without a
// mask source, global_attention.cu) and TPU kernel 3 (a2m_head_major_attention,
// head_major_attention.cu) both launch it.

#pragma once

#include <cuda_runtime.h>

namespace a2m {

// q, k, v, out: (G, S, H*hd) in one dtype, each 16-byte aligned; valid_len
// in [1, S]; block >= 0.  bits, seed and threshold name a dropout mask
// source as in global_attention.cu; the forward takes none yet (both null).
struct GlobalForwardArgs {
  const void *q, *k, *v, *bits, *seed;
  void* out;
  int G, S, H, valid_len, block, threshold;
  float scale;
  cudaStream_t stream;
};

// Launches the forward for head dim hd (16, 32 or 64) and dtype (DtypeCode);
// returns the cudaError_t of the launch: cudaErrorMisalignedAddress, with
// nothing launched, for a pointer that is not 16-byte aligned.
cudaError_t global_attention_forward(const GlobalForwardArgs& a, int hd, int dtype);

}  // namespace a2m
