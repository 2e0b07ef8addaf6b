// The eventizer's state machine on the card: frame probabilities -> the
// dense (fired, attack, duration) raster and the final (active, started).
//
// Takes the place of audio_to_midi_tpu/ops/eventize.py extract_events_dense
// (:43), a lax.scan over frames that XLA compiles; it is not a Pallas
// kernel.  Per key (reference rust common.rs:47-144), with p the (N, K)
// fp32 probabilities, frame by frame:
//   prev = ((((((0 + p[f-6]) + p[f-5]) + ...) + p[f-1]),
//   next = ((((((0 + p[f])   + p[f+1]) + ...) + p[f+5]), zero outside [0, N),
//   rising = (next / 6 - prev / 6) > 0.1, defer = p[f] < p[f+1] (false on
//   the last frame), time_ok = float(f) - float(started) > 5;
//   release when active and p < 0.1, re-activation when active, not
//   released, not deferred, p > 0.4, time_ok and rising; attack when
//   inactive and p > 0.5.  Every cell gets fired, attack = started before the
//   step and duration = max(f - started, 1), or max(f - 1 - started, 1) on a
//   re-activation, as the scan's outputs do.  The sums, divisions and the
//   difference are IEEE fp32 (__fadd_rn, __fdiv_rn, __fsub_rn: never
//   contracted, never a reciprocal), so the raster is the JAX package's bit
//   for bit; NaN compares false on both sides.
//
// What bounds it on this card: neither roof.  Its bytes are 13 per cell
// (read p, write 9 bytes of raster): 17.6 MB for 15,000 frames x 90 keys,
// 5 us at 3.35 TB/s.  What sets its floor is the chain over frames: each
// key's (active, started) at frame f needs frame f - 1's, so one key is one
// sequential walk of N steps.  The design takes everything that does not
// depend on the state off that walk, and keeps the walk from waiting:
//   1. flags_kernel, over the whole card: a block stages 32 frames (and
//      the 6-frame halo on each side) of 32 keys in shared memory, and each
//      thread folds prev and next of a cell in the order above and reduces
//      the cell to three bits -- low (p < 0.1), can_react (not low, not
//      deferred, p > 0.4, rising) and high (p > 0.5) -- written key-major
//      (a row of `pitch` bytes per key), 32 consecutive frames per warp;
//   2. walk_kernel, a lane per key (90 keys: 3 warps, each alone on an
//      SM), reads its key's row 16 frames at a time, 64 frames ahead of the
//      walk, so the chain never waits on device memory.  Per frame it is a
//      few integer and predicate operations: time_ok as the integer
//      f - started > 5, which equals the float test while f < 2^24 (the
//      entry refuses more frames); its stores of the raster are coalesced
//      across the warp's 32 keys and never waited on.
// The raster stays on the card: the wrapper (ops/eventize.py) gathers the
// fired cells into an event table there, and only that table, its count
// and the final state go to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // frames and keys of a flags_kernel block
constexpr int kRows = 8;       // thread rows of a flags_kernel block: 4 keys each
constexpr int kEdge = 6;       // frames in each rising-edge average
constexpr int kChunk = 16;     // frames a walk_kernel lane reads at once
constexpr int kAhead = 4;      // chunks read ahead of the walk
constexpr int kMaxFrames = 1 << 24;  // float(f) is exact below
constexpr int kLow = 1, kCanReact = 2, kHigh = 4;

__global__ void __launch_bounds__(kTile * kRows)
flags_kernel(const float* __restrict__ p, uint8_t* __restrict__ flags, int N, int K, int pitch) {
  __shared__ float tile[kTile + 2 * kEdge][kTile + 1];  // frames f0 - 6 .. f0 + 37
  const int f0 = blockIdx.x * kTile, key0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < (kTile + 2 * kEdge) * kTile; i += kTile * kRows) {
    const int r = i / kTile, c = i % kTile;
    const int f = f0 - kEdge + r, key = key0 + c;
    tile[r][c] = f >= 0 && f < N && key < K ? p[static_cast<long long>(f) * K + key] : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x, f = f0 + r;  // the lane's frame: row r + 6 of the tile
#pragma unroll
  for (int j = 0; j < kTile / kRows; ++j) {
    const int c = threadIdx.y + kRows * j, key = key0 + c;
    float prev = 0.f, next = 0.f;
#pragma unroll
    for (int e = 0; e < kEdge; ++e) {
      prev = __fadd_rn(prev, tile[r + e][c]);
      next = __fadd_rn(next, tile[r + kEdge + e][c]);
    }
    const float pf = tile[r + kEdge][c];
    const bool rising = __fsub_rn(__fdiv_rn(next, 6.f), __fdiv_rn(prev, 6.f)) > 0.1f;
    const bool defer = f + 1 < N && pf < tile[r + kEdge + 1][c];
    const bool low = pf < 0.1f;
    const bool can_react = !low && !defer && pf > 0.4f && rising;
    if (f < N && key < K)
      flags[static_cast<long long>(key) * pitch + f] =
          (low ? kLow : 0) | (can_react ? kCanReact : 0) | (pf > 0.5f ? kHigh : 0);
  }
}

__global__ void __launch_bounds__(32)
walk_kernel(const uint8_t* __restrict__ flags, int pitch, bool* __restrict__ fired,
            int* __restrict__ attack, int* __restrict__ duration, bool* __restrict__ final_active,
            int* __restrict__ final_started, int N, int K) {
  const int key = blockIdx.x * 32 + threadIdx.x;
  const bool mine = key < K;
  const uint4* row = reinterpret_cast<const uint4*>(flags) +
                     static_cast<long long>(mine ? key : K - 1) * (pitch / kChunk);
  const int chunks = (N + kChunk - 1) / kChunk;
  uint4 next[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) next[a] = a < chunks ? __ldg(row + a) : make_uint4(0, 0, 0, 0);
  bool active = false;
  int started = 0;
  for (int c0 = 0; c0 < chunks; c0 += kAhead) {
    uint4 cur[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      cur[a] = next[a];
      next[a] = c0 + kAhead + a < chunks ? __ldg(row + c0 + kAhead + a) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const uint32_t words[4] = {cur[a].x, cur[a].y, cur[a].z, cur[a].w};
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        const int f = (c0 + a) * kChunk + b;
        if (f >= N) break;
        const uint32_t fl = words[b / 4] >> (8 * (b % 4));
        const bool deactivate = active && (fl & kLow);
        const bool reactivate = active && (fl & kCanReact) && f - started > 5;
        const bool attack_new = !active && (fl & kHigh);
        if (mine) {
          const long long cell = static_cast<long long>(f) * K + key;
          fired[cell] = deactivate || reactivate;
          attack[cell] = started;
          duration[cell] = max(reactivate ? f - 1 - started : f - started, 1);
        }
        active = (active && !deactivate) || attack_new;
        started = reactivate || attack_new ? f : started;
      }
    }
  }
  if (mine) {
    final_active[key] = active;
    final_started[key] = started;
  }
}

}  // namespace

// Bytes of the workspace for N frames of K keys: a row of flags per key,
// padded to whole 16-byte chunks.
extern "C" long long a2m_eventize_workspace(int N, int K) {
  return static_cast<long long>(K) * ((N + kChunk - 1) / kChunk * kChunk);
}

// p: contiguous (N, K) fp32 on the device, 1 <= N <= 2^24; fired (N, K)
// bool, attack and duration (N, K) int32, final_active (K,) bool,
// final_started (K,) int32, all contiguous on the device; workspace:
// a2m_eventize_workspace(N, K) bytes, 16-byte aligned.  Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int a2m_eventize(const void* p, void* fired, void* attack, void* duration,
                            void* final_active, void* final_started, void* workspace, int N,
                            int K, void* stream) {
  if (N <= 0 || N > kMaxFrames || K <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(workspace) % 16 != 0) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pitch = (N + kChunk - 1) / kChunk * kChunk;
  uint8_t* flags = static_cast<uint8_t*>(workspace);
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile);
  flags_kernel<<<grid, dim3(kTile, kRows), 0, s>>>(static_cast<const float*>(p), flags, N, K,
                                                   pitch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  walk_kernel<<<(K + 31) / 32, 32, 0, s>>>(
      flags, pitch, static_cast<bool*>(fired), static_cast<int*>(attack),
      static_cast<int*>(duration), static_cast<bool*>(final_active),
      static_cast<int*>(final_started), N, K);
  return cudaGetLastError();
}
