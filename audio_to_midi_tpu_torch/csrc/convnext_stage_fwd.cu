// Forward of all blocks of a ConvNeXt stage, x (B, L, C) -> (B, L, C).
//
// Replaces audio_to_midi_tpu/ops/pallas_convnext.py fused_convnext_stage
// (:131, kernel _stage_kernel, :31-94).  Per block: depthwise conv k=7 SAME
// (fp32, not rounded) -> LayerNorm in fp32, rounded to the storage type ->
// 1x1 to H with the bias added in fp32 -> GELU(tanh), rounded -> 1x1 back
// with the bias added in fp32 -> times gamma in fp32, rounded -> added to
// the block's input in the storage type.
//
// What bounds it on the card: per block 4 R C H operations for R = B L rows
// (stage 5 at 16 windows: 8,000 rows, 128 -> 256: 1.05 GFLOP a block, 22
// GFLOP for its 21 blocks) over rows of 2 R C bytes in and out.  In bf16
// the products sit above the ridge only on the tensor cores; on the fp32
// cores (the design before this one: 64 x 64 tiles of fp32 FMAs, ~14
// TFLOP/s) they set the pace.  The TPU kernel keeps a cell of samples and
// all weights in fast memory for the whole stage and pads L to a multiple
// of 8; neither is needed here.  Design: three launches per block inside one
// entry (see convnext_stage.cuh for why a block is the unit) --
//   1. conv + LayerNorm (conv_ln_tile_kernel): a block stages a tile of
//      kTileRows rows and 3 halo rows on each side in shared memory with
//      16-byte loads, so that each row is read from device memory about
//      once, then runs conv_ln_row on each staged row, a warp per row --
//      the taps and the statistics in the plain version's order -> t (R,
//      C).  The instructions it runs per element (7 taps of shared loads,
//      converts, multiplies and adds, the statistics' passes) set its pace,
//      far above its bytes' bound; the widths of the default model are
//      compiled in, which cuts those instructions;
//   2. t . pw1 on the tensor cores (convnext_gemm.cuh: bf16 mma.sync, f32 as
//      3xTF32), the bias and GELU in the epilogue -> z (R, H);
//   3. z . pw2 likewise, the bias, gamma and the residual in the epilogue ->
//      the block's output, written into `out` (the first block reads x, the
//      later ones update `out` in place: each thread reads the pair of
//      elements it writes, and no other thread touches that pair).
// t and z are scratch of one block, reused by the next; rows are bounds-
// checked, so any L works.  A width whose rows do not fill whole 16-byte
// pieces, or a buffer off 16 bytes, takes the products' element copies
// (kElementCopies) and the row kernel's element loads: every geometry is
// taken, and every call repeats bit for bit.

#include <initializer_list>

#include "convnext_gemm.cuh"

namespace a2m {
namespace cnx_fwd {

using namespace a2m::cnx;

constexpr int kHalo = kTaps / 2;  // rows of a sample on each side that a row's taps reach
constexpr int kTileRows = 16;     // output rows per block of the row kernel, at most

__host__ __device__ inline int tile_warps(int rows) { return rows < kRowWarps ? rows : kRowWarps; }

// Bytes of shared memory of conv_ln_tile_kernel: the staged rows (rows + 2
// kHalo of them), then an fp32 row per warp at offset tile_bytes.
__host__ __device__ inline size_t tile_bytes(int rows, int C, size_t itemsize) {
  return (static_cast<size_t>(rows + 2 * kHalo) * C * itemsize + 15) / 16 * 16;
}

inline size_t tile_smem(int rows, int C, size_t itemsize) {
  return tile_bytes(rows, C, itemsize) + static_cast<size_t>(tile_warps(rows)) * C * sizeof(float);
}

// t = LayerNorm(conv(x)) * scale + bias in the storage type for the rows
// blockIdx.x * rows .. + rows - 1 of (R, C).  ln: (2, C) fp32, scale then
// bias.  vec: x and C * sizeof(T) fall on 16 bytes, so the tile is copied
// by 16-byte loads.  CT > 0: the width C is that constant (the default
// model's stages: 64, 128, 256), so that conv_ln_row's column loops unroll
// and its addresses fold -- the kernel is bound by the instructions it
// runs per row; 0: C as given.  Staged rows outside [0, R) are left
// unwritten: no tap reaches them (conv_ln_row reads only the taps inside a
// row's sample).
template <typename T, int CT>
__global__ void __launch_bounds__(kRowThreads)
conv_ln_tile_kernel(const T* __restrict__ x, const T* __restrict__ dw, const T* __restrict__ dwb,
                    const float* __restrict__ ln, T* __restrict__ t_out, int R, int L,
                    int width, int rows, bool vec) {
  const int C = CT > 0 ? CT : width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // staged row s: row r0 - kHalo + s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float* buf = reinterpret_cast<float*>(smem_raw + tile_bytes(rows, C, sizeof(T))) + warp * C;

  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long first = r0 - kHalo > 0 ? r0 - kHalo : 0;
  const long long last = r0 + rows + kHalo < R ? r0 + rows + kHalo : R;
  const long long count = (last - first) * C;  // elements, contiguous in x
  T* dst = tile + (first - (r0 - kHalo)) * C;
  const T* src = x + first * C;
  if (vec) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    for (long long p = threadIdx.x; p < count / kVec; p += blockDim.x) d16[p] = __ldg(s16 + p);
  } else {
    for (long long p = threadIdx.x; p < count; p += blockDim.x) dst[p] = src[p];
  }
  __syncthreads();

  for (int i = warp; i < rows; i += warps) {
    const long long r = r0 + i;
    if (r >= R) break;
    conv_ln_row<T, false>(tile, dw, dwb, i + kHalo, static_cast<int>(r % L), L, C, buf, lane);
    for (int c = lane; c < C; c += 32)
      t_out[r * C + c] = from_float<T>(__fadd_rn(__fmul_rn(buf[c], ln[c]), ln[C + c]));
  }
}

// The most rows a tile may hold at width C (0: not even one row fits).
inline int tile_rows(int C, size_t itemsize) {
  for (int rows = kTileRows; rows >= 1; rows /= 2)
    if (tile_smem(rows, C, itemsize) <= kMaxSharedBytes) return rows;
  return 0;
}

template <typename T, int CT>
cudaError_t launch_tile(const T* x, const T* dw, const T* dwb, const float* ln, T* t_out, int R,
                        int L, int C, cudaStream_t stream) {
  const auto kernel = conv_ln_tile_kernel<T, CT>;
  const int rows = tile_rows(C, sizeof(T));
  const size_t smem = tile_smem(rows, C, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(x) && static_cast<size_t>(C) * sizeof(T) % 16 == 0;
  kernel<<<(R + rows - 1) / rows, 32 * tile_warps(rows), smem, stream>>>(x, dw, dwb, ln, t_out,
                                                                          R, L, C, rows, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv_ln_tile(const T* x, const T* dw, const T* dwb, const float* ln, T* t_out,
                                int R, int L, int C, cudaStream_t stream) {
  switch (C) {
    case 64: return launch_tile<T, 64>(x, dw, dwb, ln, t_out, R, L, C, stream);
    case 128: return launch_tile<T, 128>(x, dw, dwb, ln, t_out, R, L, C, stream);
    case 256: return launch_tile<T, 256>(x, dw, dwb, ln, t_out, R, L, C, stream);
    default: return launch_tile<T, 0>(x, dw, dwb, ln, t_out, R, L, C, stream);
  }
}

// ---- epilogues of the two products ----------------------------------------
// Fed by column pairs (see mma_gemm_kernel); ELEMS: element copies and
// element loads and stores (get2 / put2).  The rows of z hold H = ld
// values, those of x and out C = ld.

template <typename T, bool ELEMS>
struct GeluEpilogue {  // z = round(gelu(acc + b))
  static constexpr bool kElementCopies = ELEMS;
  const T* bias;
  T* z;
  int ld;
  using In = float2;
  __device__ __forceinline__ In load(int, int n) const {
    return get2<ELEMS>(bias + n, n + 1 < ld);
  }
  __device__ __forceinline__ void store(int m, int n, In b, float acc0, float acc1, int) const {
    const float h0 = acc0 + b.x, h1 = acc1 + b.y;
    put2<ELEMS>(z + static_cast<size_t>(m) * ld + n, gelu_from_tanh(h0, gelu_tanh_term(h0)),
                gelu_from_tanh(h1, gelu_tanh_term(h1)), n + 1 < ld);
  }
};

// out = x + round((acc + b) * gamma), the sum in the storage type.  x may
// be out (the blocks after the first): load and store of a pair are the
// same thread's, with the loads of its 16-row slice before its stores.
template <typename T, bool ELEMS>
struct ResidualEpilogue {
  static constexpr bool kElementCopies = ELEMS;
  const T *bias, *gamma, *x;
  T* out;
  int ld;
  struct In {
    float2 bias, gamma, x;
  };
  __device__ __forceinline__ In load(int m, int n) const {
    const bool second = n + 1 < ld;
    return {get2<ELEMS>(bias + n, second), get2<ELEMS>(gamma + n, second),
            get2<ELEMS>(x + static_cast<size_t>(m) * ld + n, second)};
  }
  __device__ __forceinline__ void store(int m, int n, const In& in, float acc0, float acc1,
                                        int) const {
    const float b0 = round_to<T>((acc0 + in.bias.x) * in.gamma.x);
    const float b1 = round_to<T>((acc1 + in.bias.y) * in.gamma.y);
    put2<ELEMS>(out + static_cast<size_t>(m) * ld + n, in.x.x + b0, in.x.y + b1, n + 1 < ld);
  }
};

struct Args {
  const void *x, *dw, *dwb, *ln, *pw1, *pw1b, *pw2, *pw2b, *gamma;
  void *out, *workspace;
  int depth, B, L, C, H;
  cudaStream_t stream;
};

// The blocks of the stage with the products' tiles copied 16 bytes at a
// time (ELEMS false) or element by element (true).
template <typename T, bool ELEMS>
cudaError_t blocks(const Args& a, T* t, T* z) {
  const int R = a.B * a.L, C = a.C, H = a.H;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (int d = 0; d < a.depth; ++d) {
    const T* dw = static_cast<const T*>(a.dw) + static_cast<size_t>(d) * kTaps * C;
    const T* dwb = static_cast<const T*>(a.dwb) + static_cast<size_t>(d) * C;
    const float* ln = static_cast<const float*>(a.ln) + static_cast<size_t>(d) * 2 * C;
    const T* pw1 = static_cast<const T*>(a.pw1) + static_cast<size_t>(d) * C * H;
    const T* pw1b = static_cast<const T*>(a.pw1b) + static_cast<size_t>(d) * H;
    const T* pw2 = static_cast<const T*>(a.pw2) + static_cast<size_t>(d) * H * C;
    const T* pw2b = static_cast<const T*>(a.pw2b) + static_cast<size_t>(d) * C;
    const T* gamma = static_cast<const T*>(a.gamma) + static_cast<size_t>(d) * C;
    const T* cur = d == 0 ? x : out;

    cudaError_t err = launch_conv_ln_tile<T>(cur, dw, dwb, ln, t, R, a.L, C, a.stream);
    if (err != cudaSuccess) return err;
    // t (R, C) . pw1 (C, H): A along its rows, B down its columns.
    err = launch_mma_gemm<T, true, false>(t, pw1, R, H, C, C, H, C, 1,
                                          GeluEpilogue<T, ELEMS>{pw1b, z, H}, a.stream);
    if (err != cudaSuccess) return err;
    // z (R, H) . pw2 (H, C).
    err = launch_mma_gemm<T, true, false>(
        z, pw2, R, C, H, H, C, H, 1, ResidualEpilogue<T, ELEMS>{pw2b, gamma, cur, out, C},
        a.stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// With `need` the workspace bytes go there and nothing launches.
template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  const int R = a.B * a.L, C = a.C, H = a.H;
  Carver ws(need != nullptr ? nullptr : a.workspace);
  T* t = ws.take<T>(static_cast<size_t>(R) * C);
  T* z = ws.take<T>(static_cast<size_t>(R) * H);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }
  bool aligned = static_cast<size_t>(C) * sizeof(T) % 16 == 0 &&
                 static_cast<size_t>(H) * sizeof(T) % 16 == 0;
  for (const void* p : {a.x, a.pw1, a.pw1b, a.pw2, a.pw2b, a.gamma,
                        static_cast<const void*>(a.out), static_cast<const void*>(t),
                        static_cast<const void*>(z)})
    aligned = aligned && aligned16(p);
  return aligned ? blocks<T, false>(a, t, z) : blocks<T, true>(a, t, z);
}

static bool valid(const Args& a) {
  return a.depth >= 1 && a.B >= 1 && a.L >= 1 && a.C >= 1 && a.H >= 1 &&
         static_cast<long long>(a.B) * a.L <= 0x7fffffffLL / (a.C > a.H ? a.C : a.H) &&
         tile_rows(a.C, sizeof(float)) >= 1;
}

static cudaError_t dispatch(int dtype, const Args& a, size_t* need) {
  switch (dtype) {
    case a2m::kFloat32: return run<float>(a, need);
    case a2m::kBFloat16: return run<__nv_bfloat16>(a, need);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cnx_fwd
}  // namespace a2m

using namespace a2m::cnx_fwd;

// Bytes of workspace a call with this geometry needs (0: not taken).
extern "C" long long a2m_convnext_stage_fwd_workspace(int B, int L, int C, int H, int dtype) {
  Args a = {};
  a.depth = 1;
  a.B = B;
  a.L = L;
  a.C = C;
  a.H = H;
  size_t need = 0;
  if (!valid(a) || dispatch(dtype, a, &need) != cudaSuccess) return 0;
  return static_cast<long long>(need);
}

// x, out: contiguous (B, L, C) device buffers of one dtype, out distinct
// from x.  Weights, stacked over the stage's blocks: dw (depth, 7, C), dwb
// (depth, 1, C), ln (depth, 2, C) fp32, pw1 (depth, C, H), pw1b (depth, 1,
// H), pw2 (depth, H, C), pw2b, gamma (depth, 1, C).  workspace: at least
// a2m_convnext_stage_fwd_workspace bytes.  Returns the cudaError_t of the
// first failed launch (0 on success).
extern "C" int a2m_convnext_stage_fwd(const void* x, const void* dw, const void* dwb,
                                      const void* ln, const void* pw1, const void* pw1b,
                                      const void* pw2, const void* pw2b, const void* gamma,
                                      void* out, void* workspace, int depth, int B, int L, int C,
                                      int H, int K, int dtype, void* stream) {
  const Args a = {x, dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma, out, workspace,
                  depth, B, L, C, H, static_cast<cudaStream_t>(stream)};
  if (K != a2m::cnx::kTaps || workspace == nullptr || out == x || !valid(a))
    return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}
