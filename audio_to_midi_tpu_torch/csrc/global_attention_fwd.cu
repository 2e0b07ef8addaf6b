// The entry of the tensor-core forward of the global attention (TPU kernels
// 1, 4, 15 and 3; the body, what bounds it and its design:
// global_attention_fwd.cuh): checks the arguments and hands them to the
// launches of their dtype (global_attention_fwd_{f32,bf16}.cu).

#include <initializer_list>

#include "global_attention_fwd.cuh"

cudaError_t a2m::global_attention_forward(const a2m::GlobalForwardArgs& a, int hd, int dtype) {
  const bool dropout = a.bits != nullptr || a.seed != nullptr;
  if ((a.bits != nullptr && a.seed != nullptr) ||
      (dropout && (a.threshold <= 0 || a.threshold >= 256)) || a.S <= 0 || a.valid_len <= 0 ||
      a.valid_len > a.S || a.block < 0)
    return cudaErrorInvalidValue;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  switch (dtype) {
    case a2m::kFloat32: return a2m::global_attention_forward_f32(a, hd);
    case a2m::kBFloat16: return a2m::global_attention_forward_bf16(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
