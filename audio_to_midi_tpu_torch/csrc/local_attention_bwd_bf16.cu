// The bf16 instantiations of the two-phase local attention backward
// (local_attention_bwd.cuh): 3 head dims x 3 mask sources.

#include "local_attention_bwd.cuh"

cudaError_t a2m::local_two_phase_grads_bf16(const a2m::LocalGradsArgs& a, int hd) {
  return dispatch_hd<__nv_bfloat16>(a, hd);
}
