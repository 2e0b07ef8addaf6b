// The polyphase resampler on the card: (C, N) f32 samples -> (C, ceil(N *
// up / down)) f32, the arithmetic of ops/frontend.resample_poly_plain bit for
// bit.
//
// It replaces no TPU kernel: the JAX package's resample_poly
// (audio_to_midi_tpu/ops/frontend.py:172) is a lax.conv_general_dilated that
// XLA compiles.  It was added because the port's plain path sat far below its
// bound on this card: numpy built a (ceil(out / up), up) int64 table of input
// indices on the host every call (153.6 MB for 1200 s, ~80 ms with the card
// idle), the table was copied, and 16 gathers and ~46 broadcast elementwise
// passes moved ~24 GB where the work needs 0.58 GB.
//
// What it computes, with pad = taps * up / 2 and w the (taps, up) phase
// weights (ops/frontend._phase_weights): output m = q * up + r has its first
// tap on input sample
//   first(m) = ceil((m * down - pad) / up)   (= start(r) + q * down)
// and its phase r = m mod up, as ops/frontend.resample_taps states it:
//   y[m] = x[first] * w[0][r] + x[first + 1] * w[1][r] + ... + x[first + taps - 1] * w[taps - 1][r]
// summed left to right from the product of tap 0, every product and every sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc cannot contract them into an
// FMA), as the plain path's separate PyTorch multiply and add kernels do.  A
// tap outside [0, N) reads 0.0f and is multiplied like any other, so the sign
// of a zero sum is the plain path's too: no padded copy of the input is made.
//
// What bounds it on this card: bytes.  x read once and y written once,
// (C * N + C * out) * 4 B over 3.35 TB/s: 0.17 ms for 1200 s of stereo at 44.1
// -> 16 kHz.  Its 16 products per output are 0.6 GFLOP there, far under the
// f32 roof; what stands between it and the bytes is the load pipe of each SM
// (a shared-memory read of every tap, and its weight).  What the design does:
//   * a block computes a contiguous run of outputs of one channel (about
//     1024; fewer only where down / up is so large that their input would not
//     fit 48 KB of shared memory) and stages the input span they need,
//     ceil((outputs - 1) * down / up) + taps samples, once into shared memory
//     with 16-byte loads (4-byte loads where the input is not 16-byte
//     aligned, and at the row's ends, where samples outside the row read 0);
//   * its thread count is a multiple of up where up <= 1024 (about 256:
//     ops/frontend.resample_geometry), and a thread takes outputs i, i +
//     threads, ...: all of one phase, so the thread holds that phase's 16
//     weights in registers, loaded once (for up > 1024 it loads them for each
//     output; for a tap count other than 16 they are read tap by tap);
//   * a warp's 32 outputs are consecutive, so its weight loads (through the
//     read-only cache, taps * up floats of any size) and its stores are whole
//     128-byte lines, and its tap reads come from shared memory;
//   * the indices are 64-bit where they span the recording (the block's
//     first output and first tap), 32-bit inside a block: output m0 + i has
//     first(m0) + (i * down + up - 1 - j) / up, j = first(m0) * up - (m0 *
//     down - pad) in [0, up), and phase (m0 mod up + i) mod up, divided out
//     once for a thread's first output and stepped from there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kTileBytes = 48 * 1024;  // static shared-memory limit

__host__ __device__ inline long long ceil_div(long long a, long long b) {  // b > 0
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// Floats of a block's shared tile: the input span of per_block outputs,
// ceil((per_block - 1) * down / up) + taps, plus up to 3 before it (the
// staged start rounded down to 16 bytes), rounded up to whole float4s.
inline long long tile_floats(int per_block, int up, int down, int taps) {
  const long long span = ceil_div(static_cast<long long>(per_block - 1) * down, up) + taps;
  return (span + 3 + 3) / 4 * 4;
}

// kTaps: the taps per phase compiled in (16, the resampler's default), or 0
// for a count taken at run time.
template <int kTaps>
__global__ void __launch_bounds__(1024)
resample_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                long long n, long long out_len, long long blocks_per_row, int up, int down,
                int runtime_taps, int pad, int per_block) {
  const int taps = kTaps > 0 ? kTaps : runtime_taps;
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  const long long c = blockIdx.x / blocks_per_row;
  const long long m0 = (blockIdx.x % blocks_per_row) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block), out_len - m0));
  const long long row = c * n;
  const long long a0 = m0 * down - pad;
  const long long first0 = ceil_div(a0, up);       // the block's first tap
  const int j0 = static_cast<int>(first0 * up - a0);  // in [0, up)
  const int r0 = static_cast<int>(m0 % up);
  const long long last = first0 + (static_cast<long long>(count - 1) * down + up - 1 - j0) / up;
  // Flat samples [base, base + 4 * words4) staged: from the first tap rounded
  // down to 16 bytes to the last output's last tap.
  const long long base = (row + first0) & ~3LL;
  const int words4 = static_cast<int>((row + last + taps - base + 3) >> 2);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int k = threadIdx.x; k < words4; k += blockDim.x) {
    const long long e = base + 4LL * k;
    float4 v;
    if (aligned && e >= row && e + 4 <= row + n) {
      v = __ldg(reinterpret_cast<const float4*>(x + e));
    } else {
      v.x = e >= row && e < row + n ? __ldg(x + e) : 0.f;
      v.y = e + 1 >= row && e + 1 < row + n ? __ldg(x + e + 1) : 0.f;
      v.z = e + 2 >= row && e + 2 < row + n ? __ldg(x + e + 2) : 0.f;
      v.w = e + 3 >= row && e + 3 < row + n ? __ldg(x + e + 3) : 0.f;
    }
    tile4[k] = v;
  }
  __syncthreads();
  // Output m0 + i: its first tap (i * down + up - 1 - j0) / up samples past
  // the block's, phase (r0 + i) mod up; divided out for the thread's first
  // output, then stepped by blockDim.x outputs: blockDim.x * down = more * up
  // + extra, and the phase by turn (0 where blockDim.x is a multiple of up).
  const unsigned uup = static_cast<unsigned>(up), threads = blockDim.x;
  const unsigned more = threads * down / uup, extra = threads * down % uup;
  const unsigned turn = threads % uup;
  const unsigned num = threadIdx.x * static_cast<unsigned>(down) + (uup - 1 - j0);
  unsigned step = num / uup, left = num % uup;
  unsigned r = (static_cast<unsigned>(r0) + threadIdx.x) % uup;
  const float* s0 = tile + (row + first0 - base);
  float* out = y + c * out_len + m0;
  float wt[kTaps > 0 ? kTaps : 1];
  if (kTaps > 0) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) wt[t] = __ldg(w + t * up + r);
  }
  for (int i = threadIdx.x; i < count; i += threads) {
    const float* s = s0 + step;
    float acc;
    if (kTaps > 0) {
      acc = __fmul_rn(s[0], wt[0]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(s[t], wt[t]));
    } else {
      acc = __fmul_rn(s[0], __ldg(w + r));
      for (int t = 1; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(s[t], __ldg(w + t * up + r)));
    }
    out[i] = acc;
    step += more;
    left += extra;
    if (left >= uup) left -= uup, ++step;
    if (turn != 0) {
      r += turn;
      if (r >= uup) r -= uup;
      if (kTaps > 0) {
#pragma unroll
        for (int t = 0; t < kTaps; ++t) wt[t] = __ldg(w + t * up + r);
      }
    }
  }
}

}  // namespace

// x: contiguous (C, N) f32 on the device, any alignment; w: contiguous (taps,
// up) f32 phase weights; y: contiguous (C, out_len) f32, out_len = ceil(N *
// up / down), with up and down coprime; blocks of `threads` threads, each over
// `per_block` outputs (ops/frontend.resample_geometry).  The 32-bit
// arithmetic inside a block needs max(per_block, threads) * down + up < 2^32
// and taps * up < 2^31, and the staged input 48 KB at most (else
// cudaErrorInvalidValue, nothing launched).  Launches on `stream`, does not
// synchronize; returns the cudaError_t of the launch.
extern "C" int a2m_resample(const void* x, const void* w, void* y, long long channels,
                            long long n, long long out_len, int up, int down, int taps, int pad,
                            int threads, int per_block, void* stream) {
  if (channels < 1 || n < 1 || out_len < 1 || up < 1 || down < 1 || taps < 1 || pad < 0 ||
      threads < 1 || threads > 1024 || per_block < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(per_block > threads ? per_block : threads) * down + up >= (1LL << 32)
      || static_cast<long long>(taps) * up >= (1LL << 31))
    return cudaErrorInvalidValue;
  const long long smem = tile_floats(per_block, up, down, taps) * 4;
  if (smem > kTileBytes) return cudaErrorInvalidValue;
  const long long blocks_per_row = (out_len + per_block - 1) / per_block;
  if (blocks_per_row > (1LL << 31) - 1 || channels > ((1LL << 31) - 1) / blocks_per_row)
    return cudaErrorInvalidValue;
  auto* kernel = taps == 16 ? resample_kernel<16> : resample_kernel<0>;
  kernel<<<static_cast<unsigned>(channels * blocks_per_row), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), n,
      out_len, blocks_per_row, up, down, taps, pad, per_block);
  return cudaGetLastError();
}
