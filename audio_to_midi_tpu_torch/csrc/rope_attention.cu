// Global attention over the natural (G, S, H*hd) layout with the
// halves-layout RoPE of q and k inside.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py fused_rope_attention
// (:1229 -> pallas_call :1243, body _attention_kernel_nhd_rope :1154).  q and
// k arrive unroped.  Per head, in the order of the TPU body (:1177-1185):
// each element is rotated in fp32 by its row of the cos / sin tables
// ((S, hd/2) fp32) and rounded to the dtype, q is then scaled by 1/sqrt(hd)
// in its dtype; logits in fp32, columns at or past S never count, with
// block > 0 a column outside the row's block is -1e30; fp32 softmax;
// weights . v in fp32.  It runs the scalar online-softmax tile loop of
// attention_tile.cuh with a prologue: the rotation happens as each q and k
// tile enters shared memory, so the roped q and k never go to device memory.
// The JAX package reaches this kernel through fused_rope_attention only (its
// models rope q and k apart and call kernel 1), and so does the port.  The
// weights stay in fp32 before the product with v, where the TPU kernel casts
// them to v's dtype (and kernel 1's tensor-core body rounds them to it).
//
// What bounds it on the card: latency and the shared-memory reads of the
// scalar FMA loops, far below both roofs at the serving shapes; no product
// reaches a tensor core.  The rotation adds two reads of q or k and one of
// each table per element entering a tile: the k tile of a row block is
// rotated once per query tile (4 times at S = 250), against the separate
// rope passes and their round trips through device memory that it replaces.
// It moves onto kernel 1's tensor-core body (global_attention_fwd.cuh), as
// kernels 3, 4 and 15 have, and attention_tile.cuh goes then.

#include "attention_tile.cuh"

namespace {

template <typename T, int HD>
struct RopedRows {
  const T* __restrict__ qs;  // this (sample, head)'s row 0; rows are row_stride apart
  const T* __restrict__ ks;
  const T* __restrict__ vs;
  T* __restrict__ outs;
  const float* __restrict__ cos_table;  // (S, hd / 2)
  const float* __restrict__ sin_table;
  long long row_stride;
  float scale;

  __device__ float q(int row, int d) const {
    const float rot = a2m::rope_elem<T>(qs + row * row_stride, d, HD,
                                        cos_table + row * (HD / 2), sin_table + row * (HD / 2));
    return a2m::round_to<T>(rot * scale);
  }
  __device__ float k(int col, int d) const {
    return a2m::rope_elem<T>(ks + col * row_stride, d, HD, cos_table + col * (HD / 2),
                             sin_table + col * (HD / 2));
  }
  __device__ float v(int col, int d) const { return a2m::to_float(vs[col * row_stride + d]); }
  __device__ void store(int row, int d, float x) const {
    outs[row * row_stride + d] = a2m::from_float<T>(x);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(a2m::tile::kThreads)
rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ cos_table, const float* __restrict__ sin_table,
                      T* __restrict__ out, int S, int H, int block, float scale) {
  extern __shared__ float smem[];
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(blockIdx.z) * S * row_stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const RopedRows<T, HD> src{q + head, k + head, v + head, out + head,
                             cos_table, sin_table, row_stride, scale};
  a2m::tile::attend<HD>(src, blockIdx.x * a2m::tile::kTileQ, S, block, smem);
}

struct Args {
  const void *q, *k, *v;
  const float *cos_table, *sin_table;
  void* out;
  int G, S, H, block;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  const size_t smem = a2m::tile::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(rope_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + a2m::tile::kTileQ - 1) / a2m::tile::kTileQ, a.H, a.G);
  rope_attention_kernel<T, HD><<<grid, a2m::tile::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.cos_table, a.sin_table, static_cast<T*>(a.out), a.S, a.H, a.block, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (G, S, H*hd) device buffers of one dtype;
// cos_table, sin_table: contiguous (S, hd/2) fp32; block >= 0 (0: no block
// mask).  Returns the cudaError_t of the launch.
extern "C" int a2m_rope_attention(const void* q, const void* k, const void* v,
                                  const void* cos_table, const void* sin_table, void* out, int G,
                                  int S, int H, int hd, int block, float scale, int dtype,
                                  void* stream) {
  if (S <= 0 || block < 0) return cudaErrorInvalidValue;
  const Args a = {q, k, v, static_cast<const float*>(cos_table),
                  static_cast<const float*>(sin_table), out, G, S, H, block, scale,
                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case a2m::kFloat32: return dispatch_hd<float>(a, hd);
    case a2m::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd);
    default: return cudaErrorInvalidValue;
  }
}
