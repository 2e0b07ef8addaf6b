// Dropout masks for the attention kernels: Philox4x32-10 addressed by
// position, and the three mask sources the kernel bodies are templated on.
//
// Takes the place of the TPU kernels' per-core hardware PRNG streams
// (audio_to_midi_tpu/ops/pallas_attention.py _prng_bits, :1587).  A stream
// that is drawn in order would tie the bytes to one tiling; here the byte of
// a logit depends only on (seed, sample, core, row, column), so the forward
// kernels, the backward kernels with their other tilings, and the dump
// kernel all see the same mask without sharing any state.  One call,
//   philox4x32_10(counter = (row, column / 16, sample, core), key = seed),
// yields 16 bytes: the bytes of columns 16 * (column / 16) .. + 15 of that
// row, word w byte b (little endian) for column 16 g + 4 w + b.  A weight is
// kept where its byte >= threshold and scaled by 256 / (256 - threshold),
// exactly as with precomputed uint8 bits.  It will not give the TPU's bits.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace a2m {

// Where a kernel body takes its dropout mask from.
enum MaskSource : int {
  kMaskNone = 0,    // no dropout: the dropout-free program
  kMaskBits = 1,    // precomputed uint8 bits in device memory
  kMaskPhilox = 2,  // drawn in the kernel from a (2,) int32 seed in device memory
};

constexpr int kPhiloxGroup = 16;  // columns per Philox call

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// The 16 mask bytes of columns 16 * group .. 16 * group + 15 of one row.
__device__ __forceinline__ uint4 philox_row_group(uint2 seed, int sample, int core, int row,
                                                  int group) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(sample), static_cast<uint32_t>(core)),
                       seed);
}

__device__ __forceinline__ uint2 load_seed(const int* __restrict__ seed) {
  return make_uint2(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
}

// The mask of one attention core (one sample, one head or phase-head): the
// plane of precomputed bits, or the seed and the stream's (sample, core).
struct MaskPlane {
  const uint8_t* bits;  // kMaskBits: the core's (P, P) plane, row pitch P
  uint2 seed;           // kMaskPhilox
  int sample;
  int core;
};

template <int MASK>
__device__ __forceinline__ MaskPlane make_mask_plane(const uint8_t* __restrict__ bits,
                                                     const int* __restrict__ seed, int sample,
                                                     int core, int cores, int P) {
  MaskPlane plane = {nullptr, make_uint2(0u, 0u), sample, core};
  if (MASK == kMaskBits)
    plane.bits = bits + (static_cast<long long>(sample) * cores + core) * P * P;
  if (MASK == kMaskPhilox) plane.seed = load_seed(seed);
  return plane;
}

// Fills a 64 x 64 tile of mask bytes in shared memory (row pitch kMaskPitch)
// for rows row0.. and columns col0.. (col0 a multiple of 16) of a P x P
// plane; called by all threads of a block.  Entries outside the plane
// are never applied to a weight that counts.
constexpr int kMaskTile = 64;
constexpr int kMaskPitch = kMaskTile + 4;  // words of a row start 17 banks apart

template <int MASK>
__device__ __forceinline__ void fill_mask_tile(uint8_t* dst, const MaskPlane& plane, int row0,
                                               int col0, int P) {
  if (MASK == kMaskBits) {
    // 16 bytes of a row per step, loaded one by one (a row of the plane need
    // not be aligned) but all in flight at once, then stored as four words.
    for (int i = threadIdx.x; i < kMaskTile * (kMaskTile / 16); i += blockDim.x) {
      const int r = i / (kMaskTile / 16), c = 16 * (i % (kMaskTile / 16));
      const int row = row0 + r, col = col0 + c;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (row < P) {
        const uint8_t* src = plane.bits + static_cast<long long>(row) * P + col;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (col + b < P) words[b / 4] |= static_cast<uint32_t>(src[b]) << (8 * (b % 4));
      }
      uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * kMaskPitch + c);
#pragma unroll
      for (int w = 0; w < 4; ++w) out[w] = words[w];
    }
  }
  if (MASK == kMaskPhilox) {
    // One call per (row, group of 16 columns): 64 x 4 calls, two per thread
    // of the attention kernels' 128.
    for (int i = threadIdx.x; i < kMaskTile * (kMaskTile / kPhiloxGroup); i += blockDim.x) {
      const int r = i / (kMaskTile / kPhiloxGroup), g = i % (kMaskTile / kPhiloxGroup);
      const uint4 bytes = philox_row_group(plane.seed, plane.sample, plane.core, row0 + r,
                                           col0 / kPhiloxGroup + g);
      uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * kMaskPitch + g * kPhiloxGroup);
      out[0] = bytes.x;
      out[1] = bytes.y;
      out[2] = bytes.z;
      out[3] = bytes.w;
    }
  }
}

// Eight mask bytes of one row at columns col .. col + 7 (col a multiple of
// 8, inside the plane), packed little endian: for the 16-column windows of
// the local kernels, whose phase-B windows start 8 columns into a group.
template <int MASK>
__device__ __forceinline__ uint2 mask_bytes8(const MaskPlane& plane, int row, int col, int P) {
  if (MASK == kMaskBits) {
    const uint8_t* src = plane.bits + static_cast<long long>(row) * P + col;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= static_cast<uint32_t>(src[i]) << (8 * i);
      hi |= static_cast<uint32_t>(src[4 + i]) << (8 * i);
    }
    return make_uint2(lo, hi);
  }
  if (MASK == kMaskPhilox) {
    const uint4 bytes =
        philox_row_group(plane.seed, plane.sample, plane.core, row, col / kPhiloxGroup);
    return (col & 8) ? make_uint2(bytes.z, bytes.w) : make_uint2(bytes.x, bytes.y);
  }
  return make_uint2(0u, 0u);
}

// Inverted dropout of one fp32 value by its mask byte.
__device__ __forceinline__ float apply_mask_byte(float x, int byte, int threshold,
                                                 float keep_inv) {
  return byte >= threshold ? x * keep_inv : 0.f;
}

}  // namespace a2m
