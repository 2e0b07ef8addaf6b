// Device code shared by the fused transformer-layer kernels
// (attention_block.cu, fused_sublayer.cu, transformer_pair.cu): a row
// LayerNorm, the local (window 16, stride 8) and global attention cores with
// RoPE applied as the rows are loaded, the GLU gate, the products' epilogues
// and the host routines that chain them.
//
// The three TPU kernels are one family: row LayerNorm -> q / kv / k / v
// products -> RoPE -> masked multi-head attention -> out-proj (-> masked
// residual, -> GLU FFN).  On the TPU a grid cell keeps a few samples in fast
// memory for the whole sublayer or pair.  Here each of them is a short
// sequence of launches inside one C entry, and the kernel boundary is the
// barrier between the row-wise steps (products, LayerNorm) and the
// attention, which mixes rows.  What passes between launches lives in a
// workspace the entry carves up and whose size it reports.
//
// Roundings (audio_to_midi_tpu/ops/pallas_pair.py:49-104) are the contract
// shared with the plain versions in ops/fused_layer_kernels.py: LayerNorm in
// fp32, eps 1e-5, cast to the dtype; every product accumulates in fp32, adds
// its bias in fp32 and is cast; RoPE in fp32 on the cast values, cast back;
// q times 1/sqrt(hd) in the dtype; fp32 logits and softmax, the weights cast
// to the dtype before the product with v, which is cast again; the overlap
// average in fp32, cast; the residual add in the dtype.
//
// The products are the 64 x 64 x 16 tiles of convnext_stage.cuh on the fp32
// cores (no tensor cores yet), each with an epilogue functor below.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "convnext_stage.cuh"

namespace a2m {
namespace fl {

using cnx::Carver;
using cnx::launch_gemm;

constexpr float kLnEps = 1e-5f;
constexpr float kMaskFill = -1e30f;  // the TPU kernels' masked-logit value
constexpr int kWindow = 16;
constexpr int kStride = kWindow / 2;
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kTile = 64;            // query rows and key columns of the global core's tiles
constexpr int kCoreThreads = 256;

// ---------------------------------------------------------------------------
// Epilogues of the products (see cnx::gemm_kernel): out(m, n) from the fp32
// sum `acc`.
// ---------------------------------------------------------------------------

template <typename T>
struct StoreEpi {  // out = round(acc)
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    out[static_cast<size_t>(m) * ld + n] = from_float<T>(acc);
  }
};

template <typename T>
struct BiasEpi {  // out = round(acc + b)
  const T* bias;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    out[static_cast<size_t>(m) * ld + n] = from_float<T>(acc + to_float(bias[n]));
  }
};

// out = x + round(acc [+ b]) on the rows [lo, hi) of each sample of P rows,
// out = x on the others (their branch is masked to zero).  The sum is in
// the dtype: round(x + round(branch)).
template <typename T>
struct ResidualEpi {
  const T* x;
  const T* bias;  // may be null
  T* out;
  int ld, P, lo, hi;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    const size_t at = static_cast<size_t>(m) * ld + n;
    const int p = m % P;
    if (p < lo || p >= hi) {
      out[at] = x[at];
      return;
    }
    const float branch = round_to<T>(bias != nullptr ? acc + to_float(bias[n]) : acc);
    out[at] = from_float<T>(to_float(x[at]) + branch);
  }
};

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------

// out = LayerNorm(x) * scale + bias, cast to T; ln: (2, D) fp32.  With
// `masked`, rows outside [lo, hi) of each sample of P rows are zero.  One
// warp per row.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln, T* __restrict__ out, int R,
               int D, int P, int lo, int hi, bool masked) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  if (r >= R) return;
  const T* row = x + r * D;
  T* dst = out + r * D;
  const int p = static_cast<int>(r % P);
  if (masked && (p < lo || p >= hi)) {
    for (int c = lane; c < D; c += 32) dst[c] = from_float<T>(0.f);
    return;
  }
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += to_float(row[c]);
  const float mean = cnx::warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float cent = to_float(row[c]) - mean;
    sq += cent * cent;
  }
  const float var = cnx::warp_sum(sq) / static_cast<float>(D);
  const float rstd = 1.0f / sqrtf(var + kLnEps);
  for (int c = lane; c < D; c += 32) {
    const float y = __fmul_rn(to_float(row[c]) - mean, rstd);
    dst[c] = from_float<T>(__fadd_rn(__fmul_rn(y, ln[c]), ln[D + c]));
  }
}

// The GLU gate of the FFN: g = round(round(gelu(a)) * b) with a, b the two
// halves of a row of h1 (R, 2I); g: (R, I).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
glu_kernel(const T* __restrict__ h1, T* __restrict__ g, long long total, int inter) {
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= total) return;
  const long long r = i / inter;
  const int c = static_cast<int>(i % inter);
  const float a = to_float(h1[r * 2 * inter + c]);
  const float b = to_float(h1[r * 2 * inter + inter + c]);
  const float gelu = round_to<T>(cnx::gelu_from_tanh(a, cnx::gelu_tanh_term(a)));
  g[i] = from_float<T>(gelu * b);
}

// ---------------------------------------------------------------------------
// The local core: windows of 16 rows at stride 8 over P rows (P a multiple
// of 8), attention inside each window with RoPE positions restarting in
// every window, the overlap average.
// ---------------------------------------------------------------------------
//
// Window w covers rows [8w, 8w + 16), w in [0, P/8 - 1).  Row r of block
// k = r / 8 lies in window k (first half, position r - 8k) and window k - 1
// (second half, position r - 8k + 8), where they exist.  For P % 16 == 0
// the even windows are the TPU kernels' phase A and the odd ones phase B;
// the blocks at the two ends have one window and take its output alone,
// the others average the two: round((a + b) * 0.5), a and b each the
// window's output rounded to T.  (Kernel 11 adds in the dtype and divides
// by the count in fp32, the same number, since halving is exact.)
//
// The RoPE table row of (window w, row r at position pos):
//   kTablesByRow: table (w even ? A : B) at row r -- the per-padded-row
//   phase tables of kernels 17 and 18;
//   kTablesByWindow: table A at row 16 w + pos -- kernel 11's windowed rows.
enum TableMode : int { kTablesByRow = 0, kTablesByWindow = 1 };

// One block per (8-row block k, head, sample): 256 threads, thread
// (row i = t / 32, window half u = t / 16 % 2, key j = t % 16) -- u = 0 is
// window k, u = 1 window k - 1 -- so a (row, window) softmax reduces over 16
// lanes and a row's two windows meet in one warp.  The output row r goes to
// out row r + shift when r < limit (kernels 17 and 18 re-store the first S
// rows at offset pad_l; kernel 11 keeps all P).  What bounds it: memory --
// per (row, window) 16 keys, two products of 16 x hd.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kCoreThreads)
local_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ cos_a, const float* __restrict__ sin_a,
                  const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                  T* __restrict__ out, int P, int H, int shift, int limit, float scale) {
  constexpr int kHalf = HD / 2;
  __shared__ float sQ[2][kStride][HD + 1];   // [window half][row][d], rope'd and scaled
  __shared__ float sK[2][kWindow][HD + 1];   // [window half][key][d], rope'd
  __shared__ float sV[kWindow + kStride][HD];  // rows 8k - 8 .. 8k + 15
  __shared__ float sW[2][kStride][kWindow + 1];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x, head = blockIdx.y, sample = blockIdx.z;
  const int nb = P / kStride;
  const int W = H * HD;
  const long long base = static_cast<long long>(sample) * P;
  const int r0 = blk * kStride;

  // Window of a half and its first row; whether it exists.
  auto window_of = [&](int u) { return blk - u; };
  auto exists = [&](int u) {
    const int w = blk - u;
    return w >= 0 && w <= nb - 2;
  };
  auto table_row = [&](int u, int r, int pos, const float*& c, const float*& s) {
    const int w = window_of(u);
    if (MODE == kTablesByWindow) {
      c = cos_a + static_cast<size_t>(kWindow * w + pos) * kHalf;
      s = sin_a + static_cast<size_t>(kWindow * w + pos) * kHalf;
    } else {
      const bool even = (w & 1) == 0;
      c = (even ? cos_a : cos_b) + static_cast<size_t>(r) * kHalf;
      s = (even ? sin_a : sin_b) + static_cast<size_t>(r) * kHalf;
    }
  };

  for (int i = tid; i < 2 * kStride * HD; i += kCoreThreads) {
    const int u = i / (kStride * HD), rr = (i / HD) % kStride, d = i % HD;
    float val = 0.f;
    if (exists(u)) {
      const int r = r0 + rr;
      const int pos = u == 0 ? rr : rr + kStride;
      const float *c, *s;
      table_row(u, r, pos, c, s);
      const float rot = rope_elem<T>(q + (base + r) * W + head * HD, d, HD, c, s);
      val = scaled_in_dtype(from_float<T>(rot), scale);
    }
    sQ[u][rr][d] = val;
  }
  for (int i = tid; i < 2 * kWindow * HD; i += kCoreThreads) {
    const int u = i / (kWindow * HD), j = (i / HD) % kWindow, d = i % HD;
    float val = 0.f;
    if (exists(u)) {
      const int first = kStride * window_of(u);
      const int r = first + j;
      const float *c, *s;
      table_row(u, r, j, c, s);
      val = rope_elem<T>(k + (base + r) * W + head * HD, d, HD, c, s);
    }
    sK[u][j][d] = val;
  }
  for (int i = tid; i < (kWindow + kStride) * HD; i += kCoreThreads) {
    const int rr = i / HD, d = i % HD;
    const int r = r0 - kStride + rr;
    sV[rr][d] = r >= 0 && r < P ? to_float(v[(base + r) * W + head * HD + d]) : 0.f;
  }
  __syncthreads();

  const int row = tid >> 5;         // 0..7
  const int u = (tid >> 4) & 1;     // 0: window k, 1: window k - 1
  const int j = tid & 15;
  float logit = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) logit = fmaf(sQ[u][row][d], sK[u][j][d], logit);
  float m = logit;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = expf(logit - m);
  float l = e;
#pragma unroll
  for (int o = kWindow / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  sW[u][row][j] = round_to<T>(e / l);
  __syncwarp();

  // sV row of key c of window half u: window k starts at 8k (sV row 8),
  // window k - 1 at 8k - 8 (sV row 0).
  const int v_first = u == 0 ? kStride : 0;
  const bool have_a = exists(0), have_b = exists(1);
  const int r = r0 + row;
#pragma unroll
  for (int e2 = 0; e2 < HD / kWindow; ++e2) {
    const int d = j + kWindow * e2;
    float o = 0.f;
#pragma unroll
    for (int c = 0; c < kWindow; ++c) o = fmaf(sW[u][row][c], sV[v_first + c][d], o);
    const float mine = round_to<T>(o);
    const float other = __shfl_down_sync(0xffffffffu, mine, 16);  // lane j + 16: window k - 1
    if (u == 0 && r < limit) {
      float avg;
      if (have_a && have_b) avg = (mine + other) * 0.5f;
      else avg = have_a ? mine : other;
      out[(base + r + shift) * W + head * HD + d] = from_float<T>(avg);
    }
  }
}

// ---------------------------------------------------------------------------
// The global core: every row of a sample attends to the columns in [lo, hi)
// of its P rows; other columns take the -1e30 fill.  RoPE from one table
// row per sequence row.
// ---------------------------------------------------------------------------
//
// One block per (64 query rows, head, sample), 256 threads holding 4 x 4
// logits each.  The weights are cast to T before the product with v, so
// they need the row's final max and sum first: a first sweep over the key
// tiles takes them (online), a second computes the logits again, the
// weights and the product.  What bounds it: the logits' operations, 2 P^2 hd
// a head and sample, taken 1.5 times; no tensor cores.
template <typename T, int HD>
__global__ void __launch_bounds__(kCoreThreads)
global_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   T* __restrict__ out, int P, int H, int lo, int hi, float scale) {
  constexpr int kHalf = HD / 2;
  constexpr int kDpt = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem_core[];
  float(*sQ)[kTile + 4] = reinterpret_cast<float(*)[kTile + 4]>(smem_core);             // [d][row]
  float(*sK)[kTile + 4] = reinterpret_cast<float(*)[kTile + 4]>(smem_core + HD * (kTile + 4));  // [d][key]
  float(*sP)[kTile + 4] = reinterpret_cast<float(*)[kTile + 4]>(smem_core + 2 * HD * (kTile + 4));  // [key][row]
  float(*sV)[HD] = reinterpret_cast<float(*)[HD]>(smem_core + 2 * HD * (kTile + 4) + kTile * (kTile + 4));

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile, head = blockIdx.y, sample = blockIdx.z;
  const int W = H * HD;
  const long long base = static_cast<long long>(sample) * P;

  for (int i = tid; i < kTile * HD; i += kCoreThreads) {
    const int rr = i / HD, d = i % HD;
    const int r = q0 + rr;
    float val = 0.f;
    if (r < P) {
      const float rot = rope_elem<T>(q + (base + r) * W + head * HD, d, HD,
                                     cos_t + static_cast<size_t>(r) * kHalf,
                                     sin_t + static_cast<size_t>(r) * kHalf);
      val = scaled_in_dtype(from_float<T>(rot), scale);
    }
    sQ[d][rr] = val;
  }

  auto load_keys = [&](int c0) {
    for (int i = tid; i < kTile * HD; i += kCoreThreads) {
      const int jj = i / HD, d = i % HD;
      const int c = c0 + jj;
      sK[d][jj] = c < P ? rope_elem<T>(k + (base + c) * W + head * HD, d, HD,
                                       cos_t + static_cast<size_t>(c) * kHalf,
                                       sin_t + static_cast<size_t>(c) * kHalf)
                        : 0.f;
    }
  };
  // s[a][b]: logit of row ty*4 + a and column c0 + tx*4 + b, masked.
  auto logits = [&](int c0, float (&s)[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQ[d][ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&sK[d][tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx * 4 + b;
      const float fill = c < P ? kMaskFill : -INFINITY;  // -inf: no such column
      if (c < lo || c >= hi)
#pragma unroll
        for (int a = 0; a < 4; ++a) s[a][b] = fill;
    }
  };

  // Sweep 1: each row's max and sum of exp over all its columns.
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int c0 = 0; c0 < P; c0 += kTile) {
    __syncthreads();  // sK is free
    load_keys(c0);
    __syncthreads();
    float s[4][4];
    logits(c0, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float tmax = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float mn = fmaxf(m[a], tmax);
      float tsum = expf(s[a][0] - mn) + expf(s[a][1] - mn) + expf(s[a][2] - mn) +
                   expf(s[a][3] - mn);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
      l[a] = l[a] * expf(m[a] - mn) + tsum;
      m[a] = mn;
    }
  }

  // Sweep 2: the weights, cast to T, times v.
  float acc[4][kDpt];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kDpt; ++e) acc[a][e] = 0.f;
  for (int c0 = 0; c0 < P; c0 += kTile) {
    __syncthreads();  // sK, sP, sV are free
    load_keys(c0);
    for (int i = tid; i < kTile * HD; i += kCoreThreads) {
      const int jj = i / HD, d = i % HD;
      const int c = c0 + jj;
      sV[jj][d] = c < P ? to_float(v[(base + c) * W + head * HD + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
    logits(c0, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sP[tx * 4 + b][ty * 4 + a] = round_to<T>(expf(s[a][b] - m[a]) / l[a]);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&sP[c][ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int e = 0; e < kDpt; ++e) {
        const float vv = sV[c][tx * kDpt + e];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][e] = fmaf(pv[a], vv, acc[a][e]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty * 4 + a;
    if (r >= P) continue;
#pragma unroll
    for (int e = 0; e < kDpt; ++e)
      out[(base + r) * W + head * HD + tx * kDpt + e] = from_float<T>(acc[a][e]);
  }
}

template <int HD>
constexpr size_t global_core_smem() {
  return sizeof(float) * (2 * HD * (kTile + 4) + kTile * (kTile + 4) + kTile * HD);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The geometry of one call.  R = B P rows of width D; the attention has H
// heads of hd (W = H hd), the compressed kv C; the FFN an inner width I.
struct Geometry {
  int B, P, D, H, hd, C, I;
  long long rows() const { return static_cast<long long>(B) * P; }
  int width() const { return H * hd; }
};

// Buffers of one attention sublayer.
template <typename T>
struct AttnBuffers {
  T *normed, *q, *ckv, *k, *v, *attn;
};

template <typename T>
AttnBuffers<T> carve_attn(Carver& ws, const Geometry& g, bool with_normed) {
  const size_t R = static_cast<size_t>(g.rows());
  AttnBuffers<T> b;
  b.normed = with_normed ? ws.take<T>(R * g.D) : nullptr;
  b.q = ws.take<T>(R * g.width());
  b.ckv = ws.take<T>(R * g.C);
  b.k = ws.take<T>(R * g.width());
  b.v = ws.take<T>(R * g.width());
  b.attn = ws.take<T>(R * g.width());
  return b;
}

template <typename T>
cudaError_t launch_ln(const T* x, const float* ln, T* out, const Geometry& g, int lo, int hi,
                      bool masked, cudaStream_t stream) {
  const long long R = g.rows();
  ln_rows_kernel<T><<<static_cast<unsigned>((R + kRowWarps - 1) / kRowWarps), kRowThreads, 0,
                      stream>>>(x, ln, out, static_cast<int>(R), g.D, g.P, lo, hi, masked);
  return cudaGetLastError();
}

// q, ckv, k, v from the rows `a` (R, D).
template <typename T>
cudaError_t launch_projections(const T* a, const T* wq, const T* wkv, const T* wk, const T* wv,
                               const AttnBuffers<T>& b, const Geometry& g, cudaStream_t stream) {
  const int R = static_cast<int>(g.rows()), W = g.width();
  cudaError_t err = launch_gemm<T, true, false>(a, wq, R, W, g.D, g.D, W, g.D, 1,
                                                StoreEpi<T>{b.q, W}, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, true, false>(a, wkv, R, g.C, g.D, g.D, g.C, g.D, 1,
                                    StoreEpi<T>{b.ckv, g.C}, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, true, false>(b.ckv, wk, R, W, g.C, g.C, W, g.C, 1,
                                    StoreEpi<T>{b.k, W}, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, true, false>(b.ckv, wv, R, W, g.C, g.C, W, g.C, 1,
                                     StoreEpi<T>{b.v, W}, stream);
}

template <typename T, int HD>
cudaError_t launch_local_hd(const AttnBuffers<T>& b, const float* const* tables, int mode,
                            const Geometry& g, int shift, int limit, float scale,
                            cudaStream_t stream) {
  const dim3 grid(g.P / kStride, g.H, g.B);
  if (mode == kTablesByWindow)
    local_core_kernel<T, HD, kTablesByWindow><<<grid, kCoreThreads, 0, stream>>>(
        b.q, b.k, b.v, tables[0], tables[1], tables[0], tables[1], b.attn, g.P, g.H, shift,
        limit, scale);
  else
    local_core_kernel<T, HD, kTablesByRow><<<grid, kCoreThreads, 0, stream>>>(
        b.q, b.k, b.v, tables[0], tables[1], tables[2], tables[3], b.attn, g.P, g.H, shift,
        limit, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_global_hd(const AttnBuffers<T>& b, const float* cos_t, const float* sin_t,
                             const Geometry& g, int lo, int hi, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = global_core_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(global_core_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.P + kTile - 1) / kTile, g.H, g.B);
  global_core_kernel<T, HD><<<grid, kCoreThreads, smem, stream>>>(b.q, b.k, b.v, cos_t, sin_t,
                                                                  b.attn, g.P, g.H, lo, hi, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_local(const AttnBuffers<T>& b, const float* const* tables, int mode,
                         const Geometry& g, int shift, int limit, float scale,
                         cudaStream_t stream) {
  switch (g.hd) {
    case 16: return launch_local_hd<T, 16>(b, tables, mode, g, shift, limit, scale, stream);
    case 32: return launch_local_hd<T, 32>(b, tables, mode, g, shift, limit, scale, stream);
    case 64: return launch_local_hd<T, 64>(b, tables, mode, g, shift, limit, scale, stream);
    case 128: return launch_local_hd<T, 128>(b, tables, mode, g, shift, limit, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_global(const AttnBuffers<T>& b, const float* cos_t, const float* sin_t,
                          const Geometry& g, int lo, int hi, float scale, cudaStream_t stream) {
  switch (g.hd) {
    case 16: return launch_global_hd<T, 16>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 32: return launch_global_hd<T, 32>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 64: return launch_global_hd<T, 64>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    case 128: return launch_global_hd<T, 128>(b, cos_t, sin_t, g, lo, hi, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// One attention sublayer of kernels 17 and 18 on x (R, D) in padded
// coordinates, valid rows [pad_l, pad_l + S) of each sample:
// out = x + mask(attention(mask(LN(x))) . wo).  tables: cos_a, sin_a,
// cos_b, sin_b (local) or cos_g, sin_g (global), each (P, hd / 2) fp32.
// scale: 1/sqrt(hd) as a value of T.
template <typename T>
cudaError_t attention_sublayer(const T* x, const float* ln, const T* wq, const T* wkv,
                               const T* wk, const T* wv, const T* wo,
                               const float* const* tables, T* out, const AttnBuffers<T>& b,
                               const Geometry& g, int S, int pad_l, bool local, float scale,
                               cudaStream_t stream) {
  const int lo = pad_l, hi = pad_l + S;
  cudaError_t err = launch_ln<T>(x, ln, b.normed, g, lo, hi, true, stream);
  if (err != cudaSuccess) return err;
  err = launch_projections<T>(b.normed, wq, wkv, wk, wv, b, g, stream);
  if (err != cudaSuccess) return err;
  // The local branch's quirk: the first S rows of the average go to rows
  // pad_l + i; the residual epilogue masks the rest.
  err = local ? launch_local<T>(b, tables, kTablesByRow, g, pad_l, S, scale, stream)
              : launch_global<T>(b, tables[0], tables[1], g, lo, hi, scale, stream);
  if (err != cudaSuccess) return err;
  const int R = static_cast<int>(g.rows()), W = g.width();
  return launch_gemm<T, true, false>(b.attn, wo, R, g.D, W, W, g.D, W, 1,
                                     ResidualEpi<T>{x, nullptr, out, g.D, g.P, lo, hi}, stream);
}

// The GLU FFN sublayer of kernel 17: out = x + mask(glu(LN(x) . w1 + b1) .
// w2 + b2); the LayerNorm runs on every row, only the branch is masked.
template <typename T>
cudaError_t ffn_sublayer(const T* x, const float* ln, const T* w1, const T* b1, const T* w2,
                         const T* b2, T* out, T* normed, T* h1, T* gate, const Geometry& g, int S,
                         int pad_l, cudaStream_t stream) {
  const int R = static_cast<int>(g.rows());
  cudaError_t err = launch_ln<T>(x, ln, normed, g, 0, g.P, false, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, true, false>(normed, w1, R, 2 * g.I, g.D, g.D, 2 * g.I, g.D, 1,
                                    BiasEpi<T>{b1, h1, 2 * g.I}, stream);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(R) * g.I;
  glu_kernel<T><<<static_cast<unsigned>((total + kRowThreads - 1) / kRowThreads), kRowThreads, 0,
                  stream>>>(h1, gate, total, g.I);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<T, true, false>(gate, w2, R, g.D, g.I, g.I, g.D, g.I, 1,
                                     ResidualEpi<T>{x, b2, out, g.D, g.P, pad_l, pad_l + S},
                                     stream);
}

}  // namespace fl
}  // namespace a2m
