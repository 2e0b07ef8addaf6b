// The f32 instantiations of the global attention backward
// (global_attention_bwd.cuh): 3 head dims x 3 mask sources x 2 kernels.

#include "global_attention_bwd.cuh"

cudaError_t a2m::global_attention_grads_f32(const a2m::GlobalGradsArgs& a, int hd) {
  return dispatch_hd<float>(a, hd);
}
