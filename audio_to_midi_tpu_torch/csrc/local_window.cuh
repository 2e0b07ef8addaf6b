// The pieces the two-phase local attention's forward (local_attention_fwd.cuh,
// TPU kernels 2, 12, 5) and backward (local_attention_bwd.cuh, TPU kernels 7,
// 13, 8) share: the window, the 16-byte copies of a block's rows (zero
// outside [0, P)), the scaling of the copied pieces in T, and the 8-byte
// copy of the mask bytes.  Nothing here launches.  Kept out of mma_tile.cuh,
// whose other users' kernels need none of it.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using namespace a2m;  // the tile primitives (mma_tile.cuh)

constexpr int kWin = 16;            // the window: rows of a core, keys of a row
constexpr int kHalfWin = kWin / 2;  // the stride

// 8 bytes from device memory into shared memory, asynchronously (for the
// mask bytes: a phase-B window starts 8 columns into a 16-byte piece).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Rows row0 .. row0 + rows - 1 of one head into shared rows at row(i), 16
// bytes at a time, rows outside [0, P) zero.  Thread t copies the pieces t,
// t + threads, ...; own_pieces walks the same pieces.
template <typename T, int HD, int THREADS, typename Row>
__device__ __forceinline__ void copy_rows(Row row, const T* __restrict__ src, long long base,
                                          long long row_stride, int row0, int rows, int P) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPieces; i += THREADS) {
    const int r = i / kPieces, c = (i % kPieces) * kVec, at = row0 + r;
    const bool inside = at >= 0 && at < P;
    cp_async16(row(r) + c, src + base + static_cast<long long>(inside ? at : 0) * row_stride + c,
               inside);
  }
}

// x = round_T(x * factor(global row)) over the pieces this thread copied
// with copy_rows (visible to it once its cp_wait returns).
template <typename T, int HD, int THREADS, typename Row, typename Factor>
__device__ __forceinline__ void own_pieces(Row row, int row0, int rows, Factor factor) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPieces; i += THREADS) {
    const int r = i / kPieces;
    const float f = factor(row0 + r);
    if (f == 1.f) continue;
    T* x = row(r) + (i % kPieces) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = from_float<T>(to_float(x[e]) * f);
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

}  // namespace
