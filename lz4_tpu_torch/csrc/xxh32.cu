// B6: batched XXH32, the whole hash of each row on the card.
//
// Replaces: lz4_tpu/xxh32_device.py : _xxh32_kernel (driven by
// xxh32_blocks_pallas; the stripe accumulators of 128 rows per tile) and
// the XLA _finalize after it (seed path for rows under 16 bytes, word
// tail, byte tail, avalanche). One kernel computes the function of both
// xxh32_blocks (the XLA scan) and xxh32_blocks_pallas.
//
// What bounds it on the card: XXH32 is sequential along a row (each
// stripe's round depends on the one before), so a row takes one chain of
// about 4 dependent multiply-rotate steps per 16 bytes. With a few hundred
// rows the card cannot fill its memory pipes: the kernel is bound by that
// chain's latency, not by bytes (the byte bound of the 48 MB main-path
// batch is about 15 microseconds).
//
// What the design does about that: one thread per row, 16-byte loads
// (rows are a multiple of 16 bytes wide and 16-byte aligned), the four
// accumulators in registers, and the load of stripe s+1 independent of the
// rounds of stripe s so the loads run ahead of the arithmetic. Bytes past
// a row's length are never read into the hash.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t w) {
  return rotl(acc + w * kP2, 13) * kP1;
}

__global__ void __launch_bounds__(kThreads)
xxh32_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lens,
             long long* __restrict__ out, int B, int cap, uint32_t seed) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = data + static_cast<size_t>(b) * cap;
  const int n = min(max(lens[b], 0), cap);
  const uint4* stripes = reinterpret_cast<const uint4*>(row);
  const int ns = n / 16;
  uint32_t h;
  if (n >= 16) {
    uint32_t a0 = seed + kP1 + kP2, a1 = seed + kP2, a2 = seed,
             a3 = seed - kP1;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const uint4 w = __ldg(stripes + s);
      a0 = round32(a0, w.x);
      a1 = round32(a1, w.y);
      a2 = round32(a2, w.z);
      a3 = round32(a3, w.w);
    }
    h = rotl(a0, 1) + rotl(a1, 7) + rotl(a2, 12) + rotl(a3, 18);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint32_t>(n);
  int p = ns * 16;
  for (; p + 4 <= n; p += 4) {
    const uint32_t w = row[p] | (row[p + 1] << 8) | (row[p + 2] << 16) |
                       (static_cast<uint32_t>(row[p + 3]) << 24);
    h = rotl(h + w * kP3, 17) * kP4;
  }
  for (; p < n; ++p) h = rotl(h + row[p] * kP5, 11) * kP1;
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  out[b] = static_cast<long long>(h);
}

}  // namespace

// XXH32 of B rows of `cap` bytes (cap a multiple of 16) into int64
// values in [0, 2^32); returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_xxh32_blocks(const void* data, const void* lens,
                                 void* out, int B, int cap, uint32_t seed,
                                 void* stream) {
  xxh32_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
      static_cast<long long*>(out), B, cap, seed);
  return static_cast<int>(cudaGetLastError());
}
