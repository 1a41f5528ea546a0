// The grid of a persistent kernel: as many blocks as the card holds at once
// (SM count times the blocks an SM fits, from the occupancy calculator), no
// more than there are tiles of work.  Each block then walks the tiles in a
// grid-stride loop, so its tables are loaded once per block, not once per
// tile.  Host code; returns a cudaError_t.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

template <typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t smem,
                           long long tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  return 0;
}
