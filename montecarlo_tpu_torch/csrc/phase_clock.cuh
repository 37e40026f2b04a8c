// Per-block phase timing of a kernel with clock64() stamps, compiled in only
// with -DMC_PHASE_STAMPS (chip_profile.py's `stamps` mode builds the kernels
// so, into a build directory of its own); the default build compiles every
// call below to nothing.
//
// One thread of each block calls lap(p) at the end of each stretch of the
// kernel, which adds the SM clock cycles since the previous lap (or start())
// to phase p, and store() writes the block's kPhases sums to its row of a
// __device__ array that the kernel file exports through a *_stamps function.
#pragma once

#include <cuda_runtime.h>

namespace phase_clock {

constexpr int kPhases = 8;
constexpr int kMaxBlocks = 2048;

struct Clock {
#ifdef MC_PHASE_STAMPS
  long long t, acc[kPhases];
  __device__ __forceinline__ void start() {
    for (int p = 0; p < kPhases; ++p) acc[p] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void lap(int p) {
    const long long now = clock64();
    acc[p] += now - t;
    t = now;
  }
  __device__ __forceinline__ void store(long long* rows, int block) {
    if (block < kMaxBlocks)
      for (int p = 0; p < kPhases; ++p) rows[block * kPhases + p] = acc[p];
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void store(long long*, int) {}
#endif
};

#ifdef MC_PHASE_STAMPS
// Copy the first n_blocks rows of a stamps array to dst (host memory).
template <typename Symbol>
int copy_rows(const Symbol& rows, void* dst, int n_blocks, void* stream) {
  if (n_blocks < 0 || n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      dst, rows, sizeof(long long) * kPhases * n_blocks, 0,
      cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(st);
}
#endif

}  // namespace phase_clock
