// Writes out the dropout mask bytes that the Philox attention kernels draw.
//
// Replaces audio_to_midi_tpu/ops/pallas_attention.py _dump_bits (:1744,
// kernel _bits_dump_kernel): the oracle of the in-kernel-PRNG kernels.  For
// a seed it gives the (samples, cores, P, P) uint8 planes whose byte at
// (row, column) is the one every Philox kernel applies to that logit of
// (sample, core) -- core = head for the global attention, phase * H + head
// for the two-phase local attention.
//
// What bounds it on the card: its output bytes (8 MB for 32 x 4 x 250 x 250,
// 2.4 us at 3.35 TB/s; 16.8 MB, 5.0 us, for 32 x 8 x 256 x 256).  One
// Philox call -- ten rounds of two 32 x 32 -> 64 bit multiplies -- gives 16
// bytes, a few microseconds of integer work over the whole card.  So the
// stores have to be wide, and the indexing cheap:
//   * a block owns a run of lines (one line: the P bytes of one (sample,
//     core, row)), a multiple of 16 lines, so that the run starts and ends
//     on 16-byte boundaries of the flat output whatever P is;
//   * its threads draw the run's Philox calls, one per (line, group of 16
//     columns), into shared memory: one 16-byte store where the group is
//     whole and aligned (P % 16 == 0: 256, 496), else byte by byte, cut at
//     P (250, 37);
//   * then the run goes to device memory as 16-byte stores; only the bytes
//     of the output's end past its last whole 16 go one by one;
//   * indices are 32-bit, the (sample, core, row) of a line taken apart
//     once per call; only the run's byte offset is 64-bit.
// Staging rather than one aligned 16-byte chunk per thread: where P % 16 !=
// 0 a chunk straddles up to three calls (or many lines where P < 16); the
// staged run draws each call once and takes every P through one path.

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_dump_kernel(const int* __restrict__ seed, uint8_t* __restrict__ out, int cores, int P,
                   int groups, int lines_per_block, int total_lines) {
  extern __shared__ __align__(16) uint8_t run[];
  const int line0 = static_cast<int>(blockIdx.x) * lines_per_block;
  const int lines = min(lines_per_block, total_lines - line0);
  const uint2 key = a2m::load_seed(seed);
  for (int i = threadIdx.x; i < lines * groups; i += kThreads) {
    const int local = i / groups, group = i - local * groups;
    const int line = line0 + local;
    const int plane = line / P, row = line - plane * P;
    const int sample = plane / cores, core = plane - sample * cores;
    const uint4 bytes = a2m::philox_row_group(key, sample, core, row, group);
    const int at = local * P + group * a2m::kPhiloxGroup;
    const int n = min(a2m::kPhiloxGroup, P - group * a2m::kPhiloxGroup);
    if (n == a2m::kPhiloxGroup && at % 16 == 0) {
      *reinterpret_cast<uint4*>(run + at) = bytes;
    } else {
      const uint32_t words[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
#pragma unroll
      for (int b = 0; b < a2m::kPhiloxGroup; ++b)
        if (b < n) run[at + b] = static_cast<uint8_t>(words[b / 4] >> (8 * (b % 4)));
    }
  }
  __syncthreads();
  const int size = lines * P;
  uint8_t* dst = out + static_cast<size_t>(line0) * P;
  for (int j = threadIdx.x; j < size / 16; j += kThreads)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(run)[j];
  for (int b = size / 16 * 16 + threadIdx.x; b < size; b += kThreads) dst[b] = run[b];
}

}  // namespace

// seed: (2,) int32 on the device; out: contiguous (samples, cores, P, P)
// uint8, 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int a2m_philox_dump(const void* seed, void* out, int samples, int cores, int P,
                               void* stream) {
  if (samples <= 0 || cores <= 0 || P <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return cudaErrorInvalidValue;
  const long long total_lines = static_cast<long long>(samples) * cores * P;
  if (total_lines > 2147483647LL) return cudaErrorInvalidValue;
  // 16 lines, or a multiple of 16 that gives the block ~256 calls.
  const int lines_per_block = 16 * (P >= 256 ? 1 : 256 / P);
  const int groups = (P + a2m::kPhiloxGroup - 1) / a2m::kPhiloxGroup;
  const long long smem = static_cast<long long>(lines_per_block) * P;
  if (smem > 232448) return cudaErrorInvalidValue;  // what one block may use on sm_90
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        philox_dump_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (total_lines + lines_per_block - 1) / lines_per_block;
  philox_dump_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<uint8_t*>(out), cores, P, groups,
      lines_per_block, static_cast<int>(total_lines));
  return cudaGetLastError();
}
