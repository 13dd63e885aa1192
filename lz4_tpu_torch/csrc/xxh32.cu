// B6: batched XXH32, the whole hash of each row on the card.
//
// Replaces: lz4_tpu/xxh32_device.py : _xxh32_kernel (driven by
// xxh32_blocks_pallas; the stripe accumulators of 128 rows per tile) and
// the XLA _finalize after it (seed path for rows under 16 bytes, word
// tail, byte tail, avalanche). One kernel computes the function of both
// xxh32_blocks (the XLA scan) and xxh32_blocks_pallas.
//
// What bounds it on the card. Two floors, and the larger one is the least
// time the card could take:
// - the byte bound: every row is read once, 50.3 MB for the 768 x 64 KB
//   main-path batch, 15 us at 3.35 TB/s;
// - the chain floor: XXH32 is serial along a row. Accumulator k of stripe
//   s needs its value at stripe s - 1, so a 64 KB row is 4,096 dependent
//   rounds whatever the kernel does; the four accumulators are independent,
//   and so are the rows. A round here is two dependent instructions (a
//   multiply-add and a funnel-shift rotate), 12.3 SM cycles on an H100 with
//   nothing else in the loop; the build that runs only the rounds
//   (LZ4T_B6_CHAIN_ONLY) takes some 0.03 ms for the main-path batch and 1.7
//   ms for a 4 MB row. The chain, not the bytes, bounds the main path;
//   nothing shortens one row's chain.
// The first design (one thread per row, CTAs of 128 threads) met neither:
// 768 rows made 6 CTAs on 6 of 132 SMs, each thread streaming its own row
// with 16-byte loads, some 8 KB in flight per SM and half of every sector
// a warp touched unused. Bytes in flight set its 0.55-0.66 ms.
//
// What this design does about it:
// - Fill the card: four lanes per row, lane k runs accumulator k, 8 rows
//   to a hashing warp and one hashing warp to a CTA, so B rows make
//   ceil(B / 8) CTAs on min(ceil(B / 8), 132) SMs (96 for the main path),
//   up to 3 an SM (shared memory).
// - Take the loads off the chain: each row streams through a ring of
//   kStages stages of kStageBytes in shared memory, filled by Hopper's 1-D
//   bulk copies (cp.async.bulk). A copy warp beside the hashing warp starts
//   them (lane g for row g; the copies of 8 rows go out one lane at a time,
//   some 500 cycles a stage, so they stay off the hashing warp): chunk c of
//   a row goes to stage c % kStages once the hashing warp has released the
//   stage (its empty barrier), and completes on the stage's full barrier
//   (each row's lane arrives with expect_tx of its bytes). Up to 8 x 4 x
//   2 KB are in flight per CTA; the rounds read words from shared memory,
//   each batch of 16 loaded while the batch before runs. Each row's ring is
//   padded by 16 bytes, so the 8 rows' same-offset words fall in different
//   banks.
// - Shorten the chain: the round carries r with acc = r * kP1 (kP1 is odd),
//   r' = rotl(r * kP1 + w * kP2, 13), so w * kP2 is off the chain and a
//   round is two dependent instructions, not three.
// - Finish inside the group: the four accumulators combine with two
//   shuffles; the group's first lane adds the length, takes the tail words
//   and bytes from the ring and applies the avalanche (all of _finalize).
// Copies stop at ceil16(lens[b]) <= cap, so nothing past a row is read,
// and bytes past a row's length are never hashed.
//
// Builds for the cost split (probes/b6_split.py): LZ4T_B6_LOADS_ONLY
// (the ring filled, each stage XOR-folded instead of hashed: the byte
// time), LZ4T_B6_CHAIN_ONLY (no copies; each lane's rounds on a constant
// word: the chain floor), LZ4T_B6_CYCLES (SM cycles of the hashing warp's
// waits, rounds and releases), LZ4T_B6_ROW_THREAD (the first design, for
// comparison).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "mbarrier.cuh"
#include "smem.cuh"

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;
constexpr uint32_t kP1Inv = 244002641u;   // kP1 * kP1Inv == 1 (mod 2^32)
static_assert(kP1 * kP1Inv == 1u, "inverse of kP1");

constexpr int kLanesPerRow = 4;
constexpr int kRowsPerWarp = 32 / kLanesPerRow;
// 2 KB x 4 stages: 4 KB x 2 and 4 KB x 3 ran within 5% of it on the main
// path, 2 KB x 2 17% slower with the L2 flushed and 1 KB x 8 13% slower
// warm; 4 stages keep 3 x 16 KB in flight while one is hashed
constexpr int kStageBytes = 2048;
constexpr int kStages = 4;
constexpr int kRingPad = 16;
constexpr int kRingBytes = kStages * kStageBytes + kRingPad;   // one row
constexpr int kSmemBytes = kRowsPerWarp * kRingBytes;          // one CTA
constexpr int kStageStripes = kStageBytes / 16;
constexpr int kBatch = 16;             // rounds whose words load together
static_assert(kStageBytes % 16 == 0 && kStageBytes > 0 && kStages > 0,
              "bulk copies move multiples of 16 bytes");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t w) {
  return rotl(acc + w * kP2, 13) * kP1;
}

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  return h ^ (h >> 16);
}

// the word tail and byte tail of a row's last n - p (< 16) bytes at t
__device__ __forceinline__ uint32_t tail(uint32_t h, const uint8_t* t,
                                         int left) {
  int q = 0;
  for (; q + 4 <= left; q += 4) {
    const uint32_t w = t[q] | (t[q + 1] << 8) | (t[q + 2] << 16) |
                       (static_cast<uint32_t>(t[q + 3]) << 24);
    h = rotl(h + w * kP3, 17) * kP4;
  }
  for (; q < left; ++q) h = rotl(h + t[q] * kP5, 11) * kP1;
  return h;
}

#ifndef LZ4T_B6_ROW_THREAD

using lz4t::bar_arrive;
using lz4t::bar_arrive_tx;
using lz4t::bar_init;
using lz4t::bar_wait;
using lz4t::bulk_copy;
using lz4t::smem_addr;

// A round on the carried r, where the accumulator is r * kP1 (kP1 is odd,
// so every accumulator has one r): r' = rotl(r * kP1 + w * kP2, 13). The
// chain is one multiply-add and one rotate; w * kP2 is off it. (Written as
// rotl(acc + w * kP2, 13) * kP1, the compiler chains a multiply-add, the
// rotate and a multiply.)
#ifdef LZ4T_B6_CHAIN_ONLY
constexpr bool kChainOnly = true;
#else
constexpr bool kChainOnly = false;
#endif

#ifdef LZ4T_B6_LOADS_ONLY
__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t w) {
  return r ^ w;
}
#else
__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t w) {
  const uint32_t t = w * kP2;
  uint32_t x;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(x) : "r"(r), "r"(kP1), "r"(t));
  return rotl(x, 13);
}
#endif

// A CTA holds rows 8 * blockIdx.x + g, g < 8, in two warps. The hashing
// warp: lane k = lane % 4 of group g = lane / 4 runs accumulator k of row
// g. The copy warp: lane g starts row g's bulk copies.
__global__ void __launch_bounds__(64)
xxh32_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lens,
             long long* __restrict__ out, int B, int cap, uint32_t seed) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int lane = threadIdx.x % 32;
  const bool copier = threadIdx.x >= 32;
  const int g = copier ? lane : lane / kLanesPerRow;
  const int k = lane % kLanesPerRow;
  const int b = blockIdx.x * kRowsPerWarp + g;
  const bool live = g < kRowsPerWarp && b < B;
  const int n = live ? min(max(lens[b], 0), cap) : 0;
  const int copy_bytes = (n + 15) & ~15;           // <= cap, a multiple of 16
  const int chunks = (copy_bytes + kStageBytes - 1) / kStageBytes;
  const int max_chunks = __reduce_max_sync(0xffffffffu, chunks);
  const uint32_t full0 = smem_addr(full), empty0 = smem_addr(empty);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, kRowsPerWarp);
      bar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (copier) {
    // chunk c of each row into stage c % kStages, once the hashing warp
    // has released the chunk before it there; every row's lane arrives on
    // the stage's full barrier (rows past B and past their end with 0
    // bytes), so its phase completes when all 8 have arrived and every
    // byte has landed
    if (g >= kRowsPerWarp || kChainOnly) return;
    const uint8_t* row = data + static_cast<size_t>(live ? b : 0) * cap;
    uint8_t* my_ring = ring + g * kRingBytes;
    for (int c = 0; c < max_chunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages) bar_wait(empty0 + 8 * st, (c / kStages - 1) & 1);
      const int off = c * kStageBytes;
      const int bytes = max(0, min(kStageBytes, copy_bytes - off));
      bar_arrive_tx(full0 + 8 * st, bytes);
      if (bytes)
        bulk_copy(smem_addr(my_ring + st * kStageBytes), row + off, bytes,
                  full0 + 8 * st);
    }
    return;
  }

  const uint8_t* my_ring = ring + g * kRingBytes;
  const uint32_t a0 = seed + (k == 0 ? kP1 + kP2 : k == 1 ? kP2
                              : k == 2 ? 0u : 0u - kP1);
  uint32_t r = a0 * kP1Inv;                        // r * kP1 == a0
  const int ns = n / 16;
#ifdef LZ4T_B6_CYCLES
  long long phase[3] = {0, 0, 0}, t0 = clock64();
#define B6_TICK(p)                  \
  {                                 \
    const long long t1 = clock64(); \
    phase[p] += t1 - t0;            \
    t0 = t1;                        \
  }
#else
#define B6_TICK(p)
#endif
  for (int c = 0; c < max_chunks; ++c) {
    const int st = c % kStages;
    if (!kChainOnly) bar_wait(full0 + 8 * st, (c / kStages) & 1);
    B6_TICK(0);
    int cnt = max(0, min(kStageStripes, ns - c * kStageStripes));
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(my_ring + st * kStageBytes) + k;
    if (kChainOnly) {
      for (int i = 0; i < cnt; ++i) r = step(r, static_cast<uint32_t>(k));
      cnt = 0;
    }
    // batches of kBatch rounds, the next batch's words loaded before this
    // batch's rounds (indices clamped inside the stage; 16 ran 11% under 8
    // and 32 on the main path)
    uint32_t cur[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cur[j] = w[4 * min(j, kStageStripes - 1)];
    int i = 0;
    for (; i + kBatch <= cnt; i += kBatch) {
      uint32_t nxt[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        nxt[j] = w[4 * min(i + kBatch + j, kStageStripes - 1)];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) r = step(r, cur[j]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) cur[j] = nxt[j];
    }
    for (; i < cnt; ++i) r = step(r, w[4 * i]);
    B6_TICK(1);
    if (!kChainOnly) {
      // the warp's reads of the stage come before the copy that refills it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * st);
    }
    B6_TICK(2);
  }
#ifdef LZ4T_B6_CYCLES
  // the SM cycles of the warp's waits, rounds and releases, and its
  // chunks, in place of its first four hashes (the fifth keeps the rounds)
  if (lane == 0 && 8 * blockIdx.x + 4 < B) {
    for (int p = 0; p < 3; ++p) out[8 * blockIdx.x + p] = phase[p];
    out[8 * blockIdx.x + 3] = max_chunks;
    out[8 * blockIdx.x + 4] = r;
  }
  return;
#endif

  const int rot = k == 0 ? 1 : k == 1 ? 7 : k == 2 ? 12 : 18;
  uint32_t v = rotl(r * kP1, rot);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (k != 0 || !live) return;
  uint32_t h = (n >= 16 ? v : seed + kP5) + static_cast<uint32_t>(n);
  const int p = ns * 16;     // the tail lies in the row's last chunk
  if (p < n)
    h = tail(h, my_ring + (p / kStageBytes) % kStages * kStageBytes +
                    p % kStageBytes, n - p);
  out[b] = static_cast<long long>(avalanche(h));
}

constexpr int kThreads = 64;
constexpr int kRowsPerCta = kRowsPerWarp;
constexpr int kDynSmem = kSmemBytes;

#else  // LZ4T_B6_ROW_THREAD: the first design, one thread per row

constexpr int kThreads = 128;
constexpr int kRowsPerCta = kThreads;
constexpr int kDynSmem = 0;

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
  h = tail(h + static_cast<uint32_t>(n), row + ns * 16, n - ns * 16);
  out[b] = static_cast<long long>(avalanche(h));
}

#endif

}  // namespace

// CTAs, threads per CTA and dynamic shared memory of a launch over B rows.
extern "C" int lz4t_xxh32_grid(int B) {
  return (B + kRowsPerCta - 1) / kRowsPerCta;
}
extern "C" int lz4t_xxh32_threads() { return kThreads; }
extern "C" int lz4t_xxh32_smem() { return kDynSmem; }

// XXH32 of B rows of `cap` bytes (cap a multiple of 16, rows 16-byte
// aligned) into int64 values in [0, 2^32); returns the launch's
// cudaError_t (0 on success).
extern "C" int lz4t_xxh32_blocks(const void* data, const void* lens,
                                 void* out, int B, int cap, uint32_t seed,
                                 void* stream) {
  if (B <= 0) return 0;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e = lz4t::allow_smem(xxh32_kernel, kDynSmem, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  xxh32_kernel<<<lz4t_xxh32_grid(B), kThreads, kDynSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
      static_cast<long long*>(out), B, cap, seed);
  return static_cast<int>(cudaGetLastError());
}
