// The f32 instantiations of the two-phase local attention forward
// (local_attention_fwd.cuh): 3 head dims x 3 mask sources.

#include "local_attention_fwd.cuh"

cudaError_t a2m::local_two_phase_f32(const a2m::LocalArgs& a, int hd) {
  return dispatch_hd<float>(a, hd);
}
