// The f32 instantiations of the global attention forward
// (global_attention_fwd.cuh): 3 head dims x 3 mask sources.

#include "global_attention_fwd.cuh"

cudaError_t a2m::global_attention_forward_f32(const a2m::GlobalForwardArgs& a, int hd) {
  return forward_hd<float>(a, hd);
}
