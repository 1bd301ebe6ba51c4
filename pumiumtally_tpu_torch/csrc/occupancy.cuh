// The size of a persistent grid: how many CUDA blocks of a kernel the
// current device keeps resident at once (SMs x resident blocks per SM,
// from the occupancy query), and the shared memory one block may ask
// for. Shared by W0 (walk.cu), W3 (resident_walk.cu) and the block
// walks' schedule (block_walk_sched.cuh).

#pragma once

#include <cuda_runtime.h>

#include <mutex>

// Dynamic shared memory one CUDA block may use on an H100 (227 KB).
#define SMEM_BYTES_PER_BLOCK 232448

// The CUDA blocks of `threads` threads and `smem` bytes of dynamic shared
// memory that `kernel` keeps resident on the current device. The SM count
// and the occupancy are queried once per device, kernel, block size and
// shared-memory size and kept.
static cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, int* resident) {
  struct Entry {
    const void* kernel;
    size_t smem;
    int threads, device, resident;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int ncache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int c = 0; c < ncache; ++c)
    if (cache[c].kernel == kernel && cache[c].smem == smem &&
        cache[c].threads == threads && cache[c].device == dev) {
      *resident = cache[c].resident;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = sms * per_sm;
  if (ncache < 16) cache[ncache++] = {kernel, smem, threads, dev, *resident};
  return cudaSuccess;
}
