// Raising a kernel's dynamic shared-memory limit past the 48 KB default
// (xxh32.cu, probe_walk.cu, probe_lane.cu).
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace lz4t {

// Let `kernel` take `bytes` of dynamic shared memory; past 48 KB the
// limit is raised once a device (a bit each; devices past 63 set it on
// every launch), off the host's path of later calls. Returns the
// runtime's error (0 on success).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes,
                              std::atomic<unsigned long long>& raised) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (e == cudaSuccess && !(raised.load() & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess) raised.fetch_or(bit);
  }
  return e;
}

}  // namespace lz4t
