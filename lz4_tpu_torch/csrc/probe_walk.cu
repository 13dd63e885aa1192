// P2/P3: the scalar-walk probes, one thread walking a block in shared
// memory, and the float32 burn loop.
//
// Replaces: tools/session_pallas_probe2.py : k_smem (call :74) and k_burn
// (call :125); tools/session_pallas_probe3.py : k_a .. k_e (call :58).
// k_smem is k_a under another name: variant 0 serves both.
//
// What the probe measures. B2's parse is a chain: each token's position
// comes from the bytes of the one before, so one thread (one lane of the
// parse warp) waits for every load. On the TPU the probe walked a packed
// 66,560-byte block in SMEM with the scalar unit. Here one CTA copies its
// row into shared memory (66,560 bytes of dynamic shared memory) and one
// thread walks it with byte loads (shared memory is byte-addressed, so
// the TPU's word load, shift and mask become one ld.shared.u8), timing
// the walk alone with clock64. Its bound is latency, not bytes: the
// bytes a launch moves (8 rows of 66,560 bytes) take 0.16 us at 3.35
// TB/s, and a walk of some 26,000 dependent steps takes far longer.
//
// Variants (`variant`):
//   0 a: p += 1 + (byte & 3), acc += byte while p < n (the dependent
//        load chain, k_smem and k_a);
//   1 b: p += 3, the load beside the chain, not on it;
//   2 c: byte = (p * 7) & 255, no load;
//   3 d: one thread carrying 8 chains, chain k over [k * seg, (k+1) *
//        seg), seg = n / 8, each advancing while inside its segment (the
//        ILP answer); as k_d, each chain loads at every step, so the 8
//        loads of a step are in flight together;
//   4 e: a fixed count of `steps`, p = (p + 1 + (byte & 3)) % 65536;
//   5 d_warp: the port's own variant: d's 8 chains on 8 lanes of one
//        warp, one chain a lane (Hopper's other answer), their sums
//        joined with shuffles;
//   6 burn, "arbitrary": k_burn's grid of `grid` steps in order on one
//        thread of one CTA, each `steps` of acc = acc * 1.000001f + x[0];
//   7 burn, "parallel": the same grid as `grid` CTAs of one thread.
// The CTA of grid step g walks row g % B and writes out[g % B] (probe3's
// `pl.program_id(0) % 8`; CTAs of equal rows write equal values). n is
// clamped to [0, 4 * words_per_row], as the plain version clamps it (the
// TPU read past its SMEM there). stats[g] = (SM cycles of the walk or the
// burn loop, chain steps taken).
// The burn loop multiplies and adds with __fmul_rn / __fadd_rn, so nvcc
// does not contract them into an FMA and the kernel equals the plain
// version's float32 rounding exactly.

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 16640;           // the probe's 66,560-byte block
constexpr int kMaxSmem = kMaxWords * 4;

__device__ __forceinline__ void walk_a(const uint8_t* sb, uint32_t n,
                                       uint32_t& acc, long long& steps) {
  uint32_t p = 0, a = 0, k = 0;
  while (p < n) {
    const uint32_t byte = sb[p];
    p += 1 + (byte & 3);
    a += byte;
    ++k;
  }
  acc = a;
  steps = k;
}

__device__ __forceinline__ void walk_b(const uint8_t* sb, uint32_t n,
                                       uint32_t& acc, long long& steps) {
  uint32_t p = 0, a = 0, k = 0;
  while (p < n) {
    a += sb[p];
    p += 3;
    ++k;
  }
  acc = a;
  steps = k;
}

__device__ __forceinline__ void walk_c(uint32_t n, uint32_t& acc,
                                       long long& steps) {
  uint32_t p = 0, a = 0, k = 0;
  while (p < n) {
    const uint32_t byte = (p * 7) & 255;
    p += 1 + (byte & 3);
    a += byte;
    ++k;
  }
  acc = a;
  steps = k;
}

// As k_d: every chain loads at every step (its index clamped into the
// row, where k_d's stays in SMEM) and advances only inside its segment,
// so the 8 loads of a step do not wait for one another.
__device__ __forceinline__ void walk_d(const uint8_t* sb, uint32_t n,
                                       uint32_t last, uint32_t& acc,
                                       long long& steps) {
  const uint32_t seg = n / 8;
  uint32_t p[8], a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p[k] = k * seg;
    a[k] = 0;
  }
  uint32_t taken = 0;
  bool any = seg > 0;
  while (any) {
    uint32_t byte[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) byte[k] = sb[min(p[k], last)];
    any = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t end = (k + 1) * seg;
      const bool in = p[k] < end;
      p[k] += in ? 1 + (byte[k] & 3) : 0;
      a[k] += in ? byte[k] : 0;
      taken += in;
      any |= p[k] < end;
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += a[k];
  acc = sum;
  steps = taken;
}

__device__ __forceinline__ void walk_e(const uint8_t* sb, int count,
                                       uint32_t& acc, long long& steps) {
  uint32_t p = 0, a = 0;
  for (int i = 0; i < count; ++i) {
    const uint32_t byte = sb[p];
    p = (p + 1 + (byte & 3)) & 65535;
    a += byte;
  }
  acc = a;
  steps = count > 0 ? count : 0;
}

__global__ void __launch_bounds__(kThreads)
    walk_kernel(const int32_t* __restrict__ words,
                const int32_t* __restrict__ ns, int32_t* __restrict__ out,
                long long* __restrict__ stats, int B, int words_per_row,
                int variant, int steps) {
  extern __shared__ uint32_t s[];
  const int g = blockIdx.x;
  const int b = g % B;
  const int32_t* row = words + static_cast<size_t>(b) * words_per_row;
  for (int i = threadIdx.x; i < words_per_row; i += blockDim.x)
    s[i] = static_cast<uint32_t>(row[i]);
  __syncthreads();
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(s);
  const int n_raw = ns[b];
  const uint32_t n = n_raw < 0 ? 0u
                     : n_raw > 4 * words_per_row
                         ? static_cast<uint32_t>(4 * words_per_row)
                         : static_cast<uint32_t>(n_raw);
  uint32_t acc = 0;
  long long taken = 0;
  if (variant == 5) {                        // d_warp: lanes 0-7 of warp 0
    if (threadIdx.x >= 32) return;
    const int k = threadIdx.x;
    const uint32_t seg = n / 8;
    __syncwarp();
    const long long t0 = clock64();
    uint32_t a = 0, p = k < 8 ? k * seg : 0, end = k < 8 ? (k + 1) * seg : 0;
    long long my = 0;
    while (p < end) {
      const uint32_t byte = sb[p];
      p += 1 + (byte & 3);
      a += byte;
      ++my;
    }
    __syncwarp();
    const long long t1 = clock64();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      my += __shfl_down_sync(0xffffffffu, my, off);
    }
    if (k == 0) {
      out[b] = static_cast<int32_t>(a);
      stats[2 * g] = t1 - t0;
      stats[2 * g + 1] = my;
    }
    return;
  }
  if (threadIdx.x != 0) return;
  const long long t0 = clock64();
  switch (variant) {
    case 0: walk_a(sb, n, acc, taken); break;
    case 1: walk_b(sb, n, acc, taken); break;
    case 2: walk_c(n, acc, taken); break;
    case 3: walk_d(sb, n, 4 * words_per_row - 1, acc, taken); break;
    default: walk_e(sb, steps, acc, taken); break;
  }
  const long long t1 = clock64();
  out[b] = static_cast<int32_t>(acc);
  stats[2 * g] = t1 - t0;
  stats[2 * g + 1] = taken;
}

// k_burn: `per_cta` grid steps in order on thread 0 of each CTA. The
// input is read through a volatile pointer at every grid step, so the
// compiler cannot fold the equal grid steps into one.
__global__ void burn_kernel(const float* x, float* __restrict__ out,
                            long long* __restrict__ stats, int per_cta,
                            int steps) {
  const volatile float* xv = x;
  const long long t0 = clock64();
  for (int j = 0; j < per_cta; ++j) {
    const float x0 = *xv;
    float acc = 0.0f;
    for (int i = 0; i < steps; ++i)
      acc = __fadd_rn(__fmul_rn(acc, 1.000001f), x0);
    out[blockIdx.x * per_cta + j] = acc;
  }
  const long long t1 = clock64();
  stats[2 * blockIdx.x] = t1 - t0;
  stats[2 * blockIdx.x + 1] = static_cast<long long>(per_cta) * steps;
}

std::atomic<unsigned long long> g_raised{0};

}  // namespace

// Variants 0-5: words int32[B, words_per_row] (words_per_row <= 16640),
// ns int32[B], out int32[B], stats int64[grid, 2]; `steps` is variant
// e's count. Variants 6-7: words is x float32[1], out float32[grid],
// stats int64[1 or grid, 2], `steps` the burn loop's count. Returns the
// launch's cudaError_t (0 on success).
extern "C" int lz4t_probe_walk(const void* words, const void* ns, void* out,
                               void* stats, int B, int words_per_row,
                               int grid, int variant, int steps,
                               void* stream) {
  if (grid <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 6 || variant == 7) {
    const int ctas = variant == 6 ? 1 : grid;
    burn_kernel<<<ctas, 1, 0, st>>>(
        static_cast<const float*>(words), static_cast<float*>(out),
        static_cast<long long*>(stats), grid / ctas, steps);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant < 0 || variant > 7 || B <= 0 || words_per_row <= 0 ||
      words_per_row > kMaxWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = lz4t::allow_smem(walk_kernel, kMaxSmem, g_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  walk_kernel<<<grid, kThreads, words_per_row * 4, st>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(ns),
      static_cast<int32_t*>(out), static_cast<long long*>(stats), B,
      words_per_row, variant, steps);
  return static_cast<int>(cudaGetLastError());
}
