// The bf16 launches of the fused transformer-layer kernels (TPU kernels 11,
// 17 and 18; device code in fused_layer_impl.cuh), compiled once for the
// three entries.

#include "fused_layer_impl.cuh"

template struct a2m::fl::Layer<__nv_bfloat16>;
