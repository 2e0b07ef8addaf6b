// Backward of all blocks of a ConvNeXt stage from the saved block inputs:
// dx and the fp32 sums of the eight weight gradients.
//
// Replaces audio_to_midi_tpu/ops/pallas_convnext_bwd.py _stage_bwd_pallas
// (:217, kernel _stage_bwd_kernel, :52-183; stage_blocks_fused_bwd, :287).
// Blocks run from the last to the first.  Each recomputes its forward from
// its input x = carries[d] and rounds where the TPU kernel rounds: the conv
// output to the storage type before the fp32 LayerNorm; t, a, z, s, ds, dz,
// da, du to the storage type (biases and the residual add in it); dt, dth
// and du32 stay fp32; every weight-gradient sum is fp32.
//
// What bounds it on the card: six products of 2 R C H operations per block
// (R = B L rows; stage 5 at 32 windows: 16,000 rows, 128 x 256, 21 blocks,
// 132 GFLOP) over carries of depth R C elements read once.  On the tensor
// cores (989 TFLOP/s bf16) the products take ~0.13 ms and what is left is
// traffic: in bf16 each block's ten launches move ~190 MB of rows and
// partial sums through device memory (~57 us at 3.35 TB/s, 1.2 ms for
// stage 5).  The TPU kernel holds a sample and all of the stage's gradient
// accumulators in fast memory and sums weight gradients across a
// sequential grid.  Neither exists here; the design instead:
//   * ten launches per block inside one entry, the kernel boundary being
//     the barrier that the convolution's backward needs (du of the
//     neighbouring rows) --
//       1. conv + LayerNorm -> t;             2. t . pw1 -> a, z;
//       3. z . pw2 -> s, and ds = do * gamma; 4. ds . pw2^T -> da (over a);
//       5. da . pw1^T -> dt (fp32);
//       6. LayerNorm backward by rows -> du, and per row tile the partial
//          column sums of dgamma, dpw2b, dln, ddwb, ddw and dpw1b;
//       7. dx = do + conv^T(du), in place from the second block on;
//       8. z^T . ds and 9. t^T . da, the rows split into chunks, each
//          chunk's partial product to the workspace;
//      10. the partials summed in chunk / tile order into the outputs;
//   * the six products (2-5, 8, 9) on the tensor cores, convnext_gemm.cuh:
//     mma.sync on bf16 operands as stored, f32 as 3xTF32, tiles copied by
//     cp.async three stages deep; the epilogues round the fp32 sum to the
//     storage type where the TPU kernel does, before any bias;
//   * the rows of ONE block (t, a/da, z, s, ds, dt, du) live in a workspace
//     that every block reuses: the 2x-expanded rows are never kept for the
//     stage;
//   * no atomics: a thread owns an output element and adds its terms in a
//     fixed order, so the same inputs give the same bits.
// The LayerNorm row statistics are recomputed in step 6 by the code of step
// 1 instead of being stored.

#include "convnext_gemm.cuh"

namespace a2m {
namespace cnx_bwd {

using namespace a2m::cnx;

// ---- epilogues of the six products ---------------------------------------
// Fed by column pairs (see mma_gemm_kernel): load(m, n) reads what the
// pair (m, n), (m, n + 1) needs, store(...) writes it from the two fp32
// sums.  The rounding is the TPU kernel's, value by value.

template <typename T>
struct UpEpilogue {  // a = round(acc) + b, z = round(gelu(a))
  const T* bias;
  T *a, *z;
  int ld;
  using In = float2;
  __device__ __forceinline__ In load(int, int n) const { return load_pair(bias + n); }
  __device__ __forceinline__ void store(int m, int n, In b, float acc0, float acc1, int) const {
    const size_t at = static_cast<size_t>(m) * ld + n;
    const float a0 = round_to<T>(round_to<T>(acc0) + b.x);
    const float a1 = round_to<T>(round_to<T>(acc1) + b.y);
    store_pair<T>(a + at, a0, a1);
    store_pair<T>(z + at, gelu_from_tanh(a0, gelu_tanh_term(a0)),
                  gelu_from_tanh(a1, gelu_tanh_term(a1)));
  }
};

template <typename T>
struct DownEpilogue {  // s = round(acc) + b; ds = do * gamma
  const T *bias, *gamma, *dout;
  T *s, *ds;
  int ld;
  struct In {
    float2 bias, gamma, dout;
  };
  __device__ __forceinline__ In load(int m, int n) const {
    return {load_pair(bias + n), load_pair(gamma + n),
            load_pair(dout + static_cast<size_t>(m) * ld + n)};
  }
  __device__ __forceinline__ void store(int m, int n, const In& in, float acc0, float acc1,
                                        int) const {
    const size_t at = static_cast<size_t>(m) * ld + n;
    store_pair<T>(s + at, round_to<T>(acc0) + in.bias.x, round_to<T>(acc1) + in.bias.y);
    store_pair<T>(ds + at, in.dout.x * in.gamma.x, in.dout.y * in.gamma.y);
  }
};

template <typename T>
struct GeluGradEpilogue {  // da = round(round(acc) * gelu'(a)), written over a
  T* a;
  int ld;
  using In = float2;
  __device__ __forceinline__ In load(int m, int n) const {
    return load_pair(a + static_cast<size_t>(m) * ld + n);
  }
  __device__ __forceinline__ void store(int m, int n, In af, float acc0, float acc1, int) const {
    store_pair<T>(a + static_cast<size_t>(m) * ld + n,
                  round_to<T>(acc0) * gelu_grad_from_tanh(af.x, gelu_tanh_term(af.x)),
                  round_to<T>(acc1) * gelu_grad_from_tanh(af.y, gelu_tanh_term(af.y)));
  }
};

struct StoreEpilogue {  // out[z][m][n] = acc (fp32)
  float* out;
  int ld;
  size_t plane;
  struct In {};
  __device__ __forceinline__ In load(int, int) const { return {}; }
  __device__ __forceinline__ void store(int m, int n, In, float acc0, float acc1, int z) const {
    store_pair<float>(out + z * plane + static_cast<size_t>(m) * ld + n, acc0, acc1);
  }
};

// ---- step 6: LayerNorm backward and the partial column sums -------------

// Layout of one row tile's partial sums, and of their totals: dgamma, dpw2b
// (C each), dln (2 C: scale then bias), ddwb (C), ddw (7 C), dpw1b (H).
__host__ __device__ inline int small_count(int C, int H) { return (5 + kTaps) * C + H; }

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dw, const T* __restrict__ dwb,
              const float* __restrict__ ln, const float* __restrict__ dt,
              const T* __restrict__ dout, const T* __restrict__ s, const T* __restrict__ ds,
              const T* __restrict__ da, T* __restrict__ du, float* __restrict__ partial,
              int R, int L, int C, int H, int tile_rows) {
  extern __shared__ float smem_rows[];
  float* s_th = smem_rows;                       // (tile_rows, C) normalized rows
  float* s_du = smem_rows + tile_rows * C;       // (tile_rows, C) du in fp32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), R - r0));

  // By rows: du32 = rstd (dth - mean(dth) - th mean(dth th)), dth = dt g.
  for (int rl = warp; rl < rows; rl += kRowWarps) {
    const long long r = r0 + rl;
    float* th = s_th + rl * C;
    const float rstd =
        conv_ln_row<T, true>(x, dw, dwb, r, static_cast<int>(r % L), L, C, th, lane);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dth = dt[r * C + c] * ln[c];
      m1 += dth;
      m2 += dth * th[c];
    }
    m1 = warp_sum(m1) / static_cast<float>(C);
    m2 = warp_sum(m2) / static_cast<float>(C);
    for (int c = lane; c < C; c += 32) {
      const float dth = dt[r * C + c] * ln[c];
      const float du32 = rstd * (dth - m1 - th[c] * m2);
      s_du[rl * C + c] = du32;
      du[r * C + c] = from_float<T>(du32);
    }
  }
  __syncthreads();

  // By columns: one thread per column adds the tile's rows in order.
  float* out = partial + static_cast<size_t>(blockIdx.x) * small_count(C, H);
  for (int c = threadIdx.x; c < C; c += kRowThreads) {
    float dgamma = 0.f, dpw2b = 0.f, dln0 = 0.f, dln1 = 0.f, ddwb = 0.f;
    float ddw[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ddw[j] = 0.f;
    for (int rl = 0; rl < rows; ++rl) {
      const long long r = r0 + rl;
      const int pos = static_cast<int>(r % L);
      const long long at = r * C + c;
      dgamma += to_float(dout[at]) * to_float(s[at]);
      dpw2b += to_float(ds[at]);
      const float dtv = dt[at], thv = s_th[rl * C + c], du32 = s_du[rl * C + c];
      dln0 += dtv * thv;
      dln1 += dtv;
      ddwb += du32;
      const float dur = round_to<T>(du32);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const int off = j - kTaps / 2;
        if (pos + off >= 0 && pos + off < L) ddw[j] += dur * to_float(x[(r + off) * C + c]);
      }
    }
    out[c] = dgamma;
    out[C + c] = dpw2b;
    out[2 * C + c] = dln0;
    out[3 * C + c] = dln1;
    out[4 * C + c] = ddwb;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) out[(5 + j) * C + c] = ddw[j];
  }
  for (int h = threadIdx.x; h < H; h += kRowThreads) {
    float dpw1b = 0.f;
    for (int rl = 0; rl < rows; ++rl) dpw1b += to_float(da[(r0 + rl) * H + h]);
    out[(5 + kTaps) * C + h] = dpw1b;
  }
}

// ---- step 7: dx = do + round(conv^T(du)) --------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
conv_bwd_kernel(const T* __restrict__ du, const T* __restrict__ dw, const T* dout, T* dx, int R,
                int L, int C) {
  const long long at = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= static_cast<long long>(R) * C) return;
  const long long r = at / C;
  const int c = static_cast<int>(at % C), pos = static_cast<int>(r % L);
  float dxc = 0.f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    // y[t] += w[j] x[t + off]  =>  dx[t] += w[j] du[t - off]
    const int off = j - kTaps / 2;
    if (pos - off >= 0 && pos - off < L)
      dxc = __fadd_rn(dxc, __fmul_rn(to_float(du[(r - off) * C + c]), to_float(dw[j * C + c])));
  }
  dx[at] = from_float<T>(to_float(dout[at]) + round_to<T>(dxc));
}

// ---- step 10: partials -> the block's gradients --------------------------

struct Grads {
  float *ddw, *ddwb, *dln, *dpw1, *dpw1b, *dpw2, *dpw2b, *dgamma;  // of one block
};

__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ small, int tiles, const float* __restrict__ part1,
              const float* __restrict__ part2, int splits, int C, int H, Grads g) {
  const int n_small = small_count(C, H), ch = C * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_small) {
    float sum = 0.f;
    for (int t = 0; t < tiles; ++t) sum += small[static_cast<size_t>(t) * n_small + i];
    if (i < C) g.dgamma[i] = sum;
    else if (i < 2 * C) g.dpw2b[i - C] = sum;
    else if (i < 4 * C) g.dln[i - 2 * C] = sum;
    else if (i < 5 * C) g.ddwb[i - 4 * C] = sum;
    else if (i < (5 + kTaps) * C) g.ddw[i - 5 * C] = sum;
    else g.dpw1b[i - (5 + kTaps) * C] = sum;
  } else if (i < n_small + 2 * ch) {
    const bool first = i < n_small + ch;
    const int e = i - n_small - (first ? 0 : ch);
    const float* part = first ? part1 : part2;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[static_cast<size_t>(z) * ch + e];
    (first ? g.dpw1 : g.dpw2)[e] = sum;
  }
}

// ---- the entry -----------------------------------------------------------

struct Args {
  const void *carries, *dy, *dw, *dwb, *ln, *pw1, *pw1b, *pw2, *pw2b, *gamma;
  void *dx, *ddw, *ddwb, *dln, *dpw1, *dpw1b, *dpw2, *dpw2b, *dgamma, *workspace;
  int depth, B, L, C, H;
  cudaStream_t stream;
};

// Rows per tile of step 6: two fp32 copies of the tile's rows in shared
// memory, at most 64 KB.
static int ln_bwd_tile_rows(int C) {
  const int fit = 8192 / C;
  return fit >= 32 ? 32 : fit >= 16 ? 16 : 8;
}

// Row chunks of steps 8 and 9: enough blocks for two waves of the 132 SMs,
// each chunk a multiple of the product's depth tile and at least four of
// them.  Stage 5 (16,000 rows, 128 x 256): 63 chunks of 256 rows; stage 6
// (8,000 rows, 256 x 512): 17 of 480.
template <typename T>
static void split_rows(int R, int C, int H, int* chunk, int* splits) {
  constexpr int kK = MmaTile<T>::kK;
  const int tiles = ((C + kMmaM - 1) / kMmaM) * ((H + kMmaN - 1) / kMmaN);
  int want = (264 + tiles - 1) / tiles;
  const int most = (R + 4 * kK - 1) / (4 * kK);
  if (want > most) want = most;
  if (want < 1) want = 1;
  *chunk = ((R + want - 1) / want + kK - 1) / kK * kK;
  *splits = (R + *chunk - 1) / *chunk;
}

// The products copy 16 bytes at a time: rows of C and H values must be
// whole 16-byte pieces in either dtype.
static bool valid(const Args& a) {
  if (a.depth < 1 || a.B < 1 || a.L < 1 || a.C < 1 || a.H < 1) return false;
  if (a.C % 8 != 0 || a.H % 8 != 0) return false;
  if (static_cast<long long>(a.B) * a.L > 0x7fffffffLL / (a.C > a.H ? a.C : a.H)) return false;
  const size_t rows_smem = 2u * ln_bwd_tile_rows(a.C) * a.C * sizeof(float);
  return rows_smem <= kMaxSharedBytes;
}

// With `need` the workspace bytes go there and nothing launches.
template <typename T>
cudaError_t run(const Args& a, size_t* need) {
  const int R = a.B * a.L, C = a.C, H = a.H, L = a.L;
  const size_t rc = static_cast<size_t>(R) * C, rh = static_cast<size_t>(R) * H;
  const int tile_rows = ln_bwd_tile_rows(C);
  const int tiles = (R + tile_rows - 1) / tile_rows;
  const int n_small = small_count(C, H);
  int chunk, splits;
  split_rows<T>(R, C, H, &chunk, &splits);

  Carver ws(need != nullptr ? nullptr : a.workspace);
  T* t = ws.take<T>(rc);
  T* act = ws.take<T>(rh);   // a, then da
  T* z = ws.take<T>(rh);
  T* s = ws.take<T>(rc);
  T* ds = ws.take<T>(rc);
  T* du = ws.take<T>(rc);
  float* dt = ws.take<float>(rc);
  float* small = ws.take<float>(static_cast<size_t>(tiles) * n_small);
  float* part1 = ws.take<float>(static_cast<size_t>(splits) * C * H);
  float* part2 = ws.take<float>(static_cast<size_t>(splits) * C * H);
  if (need != nullptr) {
    *need = ws.used;
    return cudaSuccess;
  }

  const size_t rows_smem = 2u * tile_rows * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(rows_smem));
  if (err != cudaSuccess) return err;

  T* dx = static_cast<T*>(a.dx);
  const T* dout = static_cast<const T*>(a.dy);
  for (int d = a.depth - 1; d >= 0; --d) {
    const size_t at = static_cast<size_t>(d);
    const T* x = static_cast<const T*>(a.carries) + at * rc;
    const T* dw = static_cast<const T*>(a.dw) + at * kTaps * C;
    const T* dwb = static_cast<const T*>(a.dwb) + at * C;
    const float* ln = static_cast<const float*>(a.ln) + at * 2 * C;
    const T* pw1 = static_cast<const T*>(a.pw1) + at * C * H;
    const T* pw1b = static_cast<const T*>(a.pw1b) + at * H;
    const T* pw2 = static_cast<const T*>(a.pw2) + at * H * C;
    const T* pw2b = static_cast<const T*>(a.pw2b) + at * C;
    const T* gamma = static_cast<const T*>(a.gamma) + at * C;
    const Grads g = {static_cast<float*>(a.ddw) + at * kTaps * C,
                     static_cast<float*>(a.ddwb) + at * C,
                     static_cast<float*>(a.dln) + at * 2 * C,
                     static_cast<float*>(a.dpw1) + at * C * H,
                     static_cast<float*>(a.dpw1b) + at * H,
                     static_cast<float*>(a.dpw2) + at * H * C,
                     static_cast<float*>(a.dpw2b) + at * C,
                     static_cast<float*>(a.dgamma) + at * C};

    // 1-2: the forward again.  t (R, C) . pw1 (C, H): A along its rows, B
    // down its columns.
    err = launch_conv_ln<T, true>(x, dw, dwb, ln, t, R, L, C, a.stream);
    if (err != cudaSuccess) return err;
    err = launch_mma_gemm<T, true, false>(t, pw1, R, H, C, C, H, C, 1,
                                          UpEpilogue<T>{pw1b, act, z, H}, a.stream);
    if (err != cudaSuccess) return err;
    // 3: z (R, H) . pw2 (H, C).
    err = launch_mma_gemm<T, true, false>(z, pw2, R, C, H, H, C, H, 1,
                                          DownEpilogue<T>{pw2b, gamma, dout, s, ds, C}, a.stream);
    if (err != cudaSuccess) return err;
    // 4: ds (R, C) . pw2^T: both operands along their rows.
    err = launch_mma_gemm<T, true, true>(ds, pw2, R, H, C, C, C, C, 1,
                                         GeluGradEpilogue<T>{act, H}, a.stream);
    if (err != cudaSuccess) return err;
    // 5: da (R, H) . pw1^T.
    err = launch_mma_gemm<T, true, true>(act, pw1, R, C, H, H, H, H, 1,
                                         StoreEpilogue{dt, C, 0}, a.stream);
    if (err != cudaSuccess) return err;
    // 6.
    ln_bwd_kernel<T><<<tiles, kRowThreads, rows_smem, a.stream>>>(
        x, dw, dwb, ln, dt, dout, s, ds, act, du, small, R, L, C, H, tile_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // 7.
    const long long elements = static_cast<long long>(rc);
    conv_bwd_kernel<T><<<static_cast<unsigned>((elements + 255) / 256), 256, 0, a.stream>>>(
        du, dw, dout, dx, R, L, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // 8: dpw2 (H, C) = z^T . ds and 9: dpw1 (C, H) = t^T . da, rows as depth:
    // both operands down their columns.
    err = launch_mma_gemm<T, false, false>(z, ds, H, C, R, H, C, chunk, splits,
                                           StoreEpilogue{part2, C, static_cast<size_t>(C) * H},
                                           a.stream);
    if (err != cudaSuccess) return err;
    err = launch_mma_gemm<T, false, false>(t, act, C, H, R, C, H, chunk, splits,
                                           StoreEpilogue{part1, H, static_cast<size_t>(C) * H},
                                           a.stream);
    if (err != cudaSuccess) return err;
    // 10.
    const int outputs = n_small + 2 * C * H;
    reduce_kernel<<<(outputs + 255) / 256, 256, 0, a.stream>>>(small, tiles, part1, part2,
                                                              splits, C, H, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dout = dx;  // the next block's cotangent, updated in place from here on
  }
  return cudaSuccess;
}

static cudaError_t dispatch(int dtype, const Args& a, size_t* need) {
  switch (dtype) {
    case a2m::kFloat32: return run<float>(a, need);
    case a2m::kBFloat16: return run<__nv_bfloat16>(a, need);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cnx_bwd
}  // namespace a2m

using namespace a2m::cnx_bwd;

// Bytes of workspace a call with this geometry needs (0: not taken).
extern "C" long long a2m_convnext_stage_bwd_workspace(int B, int L, int C, int H, int dtype) {
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

// carries: contiguous (depth, B, L, C), block d's input; dy, dx: (B, L, C),
// dx distinct from dy; all of one dtype.  Weights stacked over the blocks as
// for a2m_convnext_stage_fwd.  The gradients are fp32, shaped like their
// weights, and fully overwritten.  workspace: at least
// a2m_convnext_stage_bwd_workspace bytes.  Returns the cudaError_t of the
// first failed launch (0 on success).
extern "C" int a2m_convnext_stage_bwd(
    const void* carries, const void* dy, const void* dw, const void* dwb, const void* ln,
    const void* pw1, const void* pw1b, const void* pw2, const void* pw2b, const void* gamma,
    void* dx, void* ddw, void* ddwb, void* dln, void* dpw1, void* dpw1b, void* dpw2,
    void* dpw2b, void* dgamma, void* workspace, int depth, int B, int L, int C, int H, int K,
    int dtype, void* stream) {
  const Args a = {carries, dy, dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma,
                  dx, ddw, ddwb, dln, dpw1, dpw1b, dpw2, dpw2b, dgamma, workspace,
                  depth, B, L, C, H, static_cast<cudaStream_t>(stream)};
  if (K != a2m::cnx::kTaps || workspace == nullptr || dx == dy || !valid(a))
    return cudaErrorInvalidValue;
  // The products' operands are copied 16 bytes at a time.
  if (!a2m::aligned16(pw1) || !a2m::aligned16(pw2) || !a2m::aligned16(workspace))
    return cudaErrorInvalidValue;
  return dispatch(dtype, a, nullptr);
}
