// Writes out the dropout mask bytes that the Philox attention kernels draw.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py _dump_bits (:1744,
// kernel _bits_dump_kernel): the oracle of the in-kernel-PRNG kernels.  For
// a seed it gives the (samples, cores, P, P) uint8 planes whose byte at
// (row, column) is the one every Philox kernel applies to that logit of
// (sample, core) -- core = head for the global attention, phase * H + head
// for the two-phase local attention.
//
// What bounds it on the card: its output bytes (B x cores x P x P, 8 MB for
// 32 x 4 x 250 x 250) against one Philox call -- ten rounds of two 32 x 32
// -> 64 bit multiplies -- per 16 bytes.  One thread draws one call and
// stores its 16 bytes; P need not be a multiple of 16, so the stores are
// bytes and the last group of a row is cut at P.

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_dump_kernel(const int* __restrict__ seed, uint8_t* __restrict__ out, int cores, int P,
                   int groups, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int group = static_cast<int>(idx % groups);
  const long long line = idx / groups;  // (sample, core, row)
  const int row = static_cast<int>(line % P);
  const int core = static_cast<int>((line / P) % cores);
  const int sample = static_cast<int>(line / P / cores);
  const uint4 bytes = a2m::philox_row_group(a2m::load_seed(seed), sample, core, row, group);
  const uint32_t words[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
  uint8_t* dst = out + line * P;
#pragma unroll
  for (int i = 0; i < a2m::kPhiloxGroup; ++i) {
    const int col = group * a2m::kPhiloxGroup + i;
    if (col < P) dst[col] = static_cast<uint8_t>(words[i / 4] >> (8 * (i % 4)));
  }
}

}  // namespace

// seed: (2,) int32 on the device; out: contiguous (samples, cores, P, P)
// uint8.  Returns the cudaError_t of the launch (0 on success).
extern "C" int a2m_philox_dump(const void* seed, void* out, int samples, int cores, int P,
                               void* stream) {
  if (samples <= 0 || cores <= 0 || P <= 0) return cudaErrorInvalidValue;
  const int groups = (P + a2m::kPhiloxGroup - 1) / a2m::kPhiloxGroup;
  const long long total = static_cast<long long>(samples) * cores * P * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  philox_dump_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<uint8_t*>(out), cores, P, groups, total);
  return cudaGetLastError();
}
