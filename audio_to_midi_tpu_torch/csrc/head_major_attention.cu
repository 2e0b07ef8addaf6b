// Multi-head attention over the head-major (G, H, S, hd) layout.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_attention (:219;
// _fused_attention_impl :170 -> pallas_call :190, body _attention_kernel
// :36).  Per (sample, head): logits = (q * 1/sqrt(hd), scaled in q's dtype)
// . k^T in fp32, columns at or past S never count, with block > 0 a column
// outside the row's block is -1e30; fp32 softmax; weights . v in fp32.  The
// TPU kernel pads S to 128 and packs h_per heads into one cell, kept apart
// by a block-diagonal mask: both are its VMEM layout, not its function.
// Here a head is contiguous (S, hd) rows, so kernel 1's tile loop
// (attention_tile.cuh) runs on it with the row stride hd instead of H*hd,
// and the ragged key edge is excluded inside the loop.  The JAX package
// reaches this kernel through fused_attention only (tests; kernel 1
// superseded it on the model's paths), and so does the port.  Like kernel 1,
// the weights stay in fp32 before the product with v, where the TPU kernel
// casts them to v's dtype.
//
// What bounds it on the card: as kernel 1 at the same shapes -- at 16
// windows of S = 250, 4 heads x 64, ~1 GFLOP of scalar FMAs and ~4 MB, far
// below both roofs: latency, the shared-memory reads of the FMA loops, and
// how many blocks keep the SMs busy (4 x 4 x 16 = 256 blocks here).

#include "attention_tile.cuh"

namespace {

template <typename T, int HD>
struct HeadMajorRows {
  const T* __restrict__ qs;  // this (sample, head)'s (S, hd) rows
  const T* __restrict__ ks;
  const T* __restrict__ vs;
  T* __restrict__ outs;
  float scale;

  __device__ float q(int row, int d) const {
    return a2m::scaled_in_dtype(qs[row * HD + d], scale);
  }
  __device__ float k(int col, int d) const { return a2m::to_float(ks[col * HD + d]); }
  __device__ float v(int col, int d) const { return a2m::to_float(vs[col * HD + d]); }
  __device__ void store(int row, int d, float x) const {
    outs[row * HD + d] = a2m::from_float<T>(x);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(a2m::tile::kThreads)
head_major_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out, int H, int S, int block,
                            float scale) {
  extern __shared__ float smem[];
  const long long head = (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * S * HD;
  const HeadMajorRows<T, HD> src{q + head, k + head, v + head, out + head, scale};
  a2m::tile::attend<HD>(src, blockIdx.x * a2m::tile::kTileQ, S, block, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int G, int H, int S,
                   int block, float scale, cudaStream_t stream) {
  const size_t smem = a2m::tile::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(head_major_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + a2m::tile::kTileQ - 1) / a2m::tile::kTileQ, H, G);
  head_major_attention_kernel<T, HD><<<grid, a2m::tile::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, S, block, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int G, int H,
                        int S, int hd, int block, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, G, H, S, block, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, G, H, S, block, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, G, H, S, block, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (G, H, S, hd) device buffers of one dtype; block
// >= 0 (0: no block mask).  Returns the cudaError_t of the launch.
extern "C" int a2m_head_major_attention(const void* q, const void* k, const void* v, void* out,
                                        int G, int H, int S, int hd, int block, float scale,
                                        int dtype, void* stream) {
  if (S <= 0 || block < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(q, k, v, out, G, H, S, hd, block, scale, s);
    case a2m::kBFloat16:
      return dispatch_hd<__nv_bfloat16>(q, k, v, out, G, H, S, hd, block, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
