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
//        load chain, k_smem and k_a), its exit tested every step as B2's
//        parse tests its bounds every token;
//   1 b: p += 3, the load beside the chain, not on it: its trip count,
//        ceil(n / 3), is known before the loop, so it runs blocks of U = 8
//        steps whose loads are off every chain and can be in flight
//        together, their bytes joining acc two an IADD3, then the last
//        steps one by one;
//   2 c: byte = (p * 7) & 255, no load; a step advances p by 1-4, so
//        while p + 4 (U - 1) < n the next U steps all run: blocks of U
//        steps with one exit test each, then the tested loop;
//   3 d: one thread carrying 8 chains, chain k over [k * seg, (k+1) *
//        seg), seg = n / 8, each advancing while inside its segment (the
//        ILP answer); as k_d, each chain loads at every step, so the 8
//        loads of a step are in flight together. While every chain has
//        p_k + 4 (U - 1) < its end, blocks of U steps run all 8 chains
//        without the guards (no select, clamp or `any`); the tails then
//        run guarded;
//   4 e: a fixed count of `steps`, p = (p + 1 + (byte & 3)) % 65536;
//   5 d_warp: the port's own variant: d's 8 chains on 8 lanes of one
//        warp, one chain a lane (Hopper's other answer), their sums
//        joined with shuffles;
//   6 burn, "arbitrary": k_burn's grid of `grid` steps, each `steps` of
//        acc = acc * 1.000001f + x[0], as the lanes of one CTA (grid step
//        g on thread g; 16 steps are 16 lanes of one warp);
//   7 burn, "parallel": the same grid as `grid` CTAs of one thread.
// The CTA of grid step g walks row g % B and writes out[g % B] (probe3's
// `pl.program_id(0) % 8`; CTAs of equal rows write equal values). n is
// clamped to [0, 4 * words_per_row], as the plain version clamps it (the
// TPU read past its SMEM there). Walks: stats[g] = (SM cycles of the
// walk, chain steps taken). Burn: stats[g] = (SM cycles of grid step g's
// loop, its steps, the CTA that ran it).
// The burn loop multiplies and adds with __fmul_rn / __fadd_rn, so nvcc
// does not contract them into an FMA and the kernel equals the plain
// version's float32 rounding exactly. TPU "arbitrary" semantics keep the
// grid on one TensorCore; they do not make it sequential, and out[g]
// reads no other grid step, so the 16 chains run side by side on one SM
// (one warp issues each step once for all 16) where the first port ran
// them one after another on one thread.
//
// The latency build (-DLZ4T_PROBE_LATENCY, variant 8; not in the default
// build) prices the instruction classes on the probe bodies' dependent
// chains: one warp, lane 0 timing dependent chains of `steps` (4096)
// instructions of each class with clock64 (SHFL with the whole warp),
// each as a chain of 2 * steps less one of steps, so the clock reads and
// the loop's entry cancel:
//   0 LDS, a 32-bit shared-memory load whose address is the last load's
//     value; 1 and 2 a global __ldg pointer chase, over a 4 KB ring that
//     an untimed pass put in L1 (L1 hit), and over a 4 MB ring of
//     32,768 lines that an untimed pass put in L2 and whose lines left
//     L1 long before (L1 miss, L2 hit: 3 * steps loads, none of a line
//     loaded since); 3 LOP3, IADD3, LOP3 ((x + y + (x & 3)) & z, three a
//     step, walk e's ALU); 4 IMAD (x * y + z); 5 FMUL and FADD (burn's
//     step, two a step); 6 SHFL (a butterfly shuffle of the last result).
//   stats[k] = (SM cycles, instructions) of class k; stats[7] = (SM
//   cycles, globaltimer ns) of the launch, the SM clock it ran at. The
//   rings are int64 words holding the address of the next.
//
// Two builds vary the loads a thread has in flight, each computing what
// the default build computes (`walk_probe --inflight` times them in turns
// with it): -DLZ4T_D_INFLIGHT=K (2 or 4; 8 is the default) runs d's
// unguarded blocks on K chains at a time, a group after the other, where
// the default runs all 8; -DLZ4T_B_PIPELINE issues b's loads of the next
// block before it sums the current one.

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 16640;           // the probe's 66,560-byte block
constexpr int kMaxSmem = kMaxWords * 4;
// U: the steps of b, c and d that run as a block, with one exit test; a
// step advances p by at most 4 (`walk_probe.BLOCK`)
constexpr uint32_t kBlock = 8;
constexpr uint32_t kReach = 4 * (kBlock - 1);  // p's most a block's last step
static_assert(kBlock == 8, "walk_b sums a block's 8 bytes as a tree");
#ifndef LZ4T_D_INFLIGHT
#define LZ4T_D_INFLIGHT 8
#endif
constexpr int kInflight = LZ4T_D_INFLIGHT;   // d's chains a block runs
static_assert(kInflight > 0 && 8 % kInflight == 0, "8 chains in groups");

__device__ __forceinline__ uint32_t sum8(const uint32_t (&b)[kBlock]) {
  return ((b[0] + b[1]) + (b[2] + b[3])) + ((b[4] + b[5]) + (b[6] + b[7]));
}

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
  const uint32_t count = (n + 2) / 3;          // p = 0, 3, ... while p < n
  uint32_t a = 0, k = 0;
  const uint8_t* q = sb;
#ifdef LZ4T_B_PIPELINE
  if (count >= kBlock) {
    uint32_t b[kBlock];
#pragma unroll
    for (uint32_t j = 0; j < kBlock; ++j) b[j] = q[3 * j];
    for (k = kBlock; k + kBlock <= count; k += kBlock) {
      q += 3 * kBlock;
      uint32_t c[kBlock];
#pragma unroll
      for (uint32_t j = 0; j < kBlock; ++j) c[j] = q[3 * j];
      a += sum8(b);
#pragma unroll
      for (uint32_t j = 0; j < kBlock; ++j) b[j] = c[j];
    }
    a += sum8(b);
    q += 3 * kBlock;
  }
#else
  for (; k + kBlock <= count; k += kBlock, q += 3 * kBlock) {
    uint32_t b[kBlock];
#pragma unroll
    for (uint32_t j = 0; j < kBlock; ++j) b[j] = q[3 * j];
    a += sum8(b);
  }
#endif
  for (; k < count; ++k, q += 3) a += *q;
  acc = a;
  steps = count;
}

__device__ __forceinline__ void walk_c(uint32_t n, uint32_t& acc,
                                       long long& steps) {
  uint32_t p = 0, a = 0, k = 0;
  const uint32_t lim = n > kReach ? n - kReach : 0;  // p < lim: U steps run
  while (p < lim) {
#pragma unroll
    for (uint32_t j = 0; j < kBlock; ++j) {
      const uint32_t byte = (p * 7) & 255;
      p += 1 + (byte & 3);
      a += byte;
    }
    k += kBlock;
  }
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
// so the 8 loads of a step do not wait for one another. The unguarded
// blocks read inside every segment (p_k < end_k <= n), so need no clamp.
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
  if (seg > kReach) {
    const uint32_t lim = seg - kReach;   // chain k: p_k - k * seg < lim
#pragma unroll
    for (int g = 0; g < 8; g += kInflight) {
      bool all = true;
      while (all) {
#pragma unroll
        for (uint32_t j = 0; j < kBlock; ++j) {
#pragma unroll
          for (int k = g; k < g + kInflight; ++k) {
            const uint32_t byte = sb[p[k]];
            p[k] += 1 + (byte & 3);
            a[k] += byte;
          }
        }
        taken += kInflight * kBlock;
#pragma unroll
        for (int k = g; k < g + kInflight; ++k) all &= p[k] < k * seg + lim;
      }
    }
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) any |= p[k] < (k + 1) * seg;
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

// k_burn: grid step g on thread g % blockDim.x of CTA g / blockDim.x (a
// thread takes g, g + all threads, ... where the grid is larger). The
// input is read through a volatile pointer at every grid step, so the
// compiler cannot fold the equal grid steps into one.
__global__ void burn_kernel(const float* x, float* __restrict__ out,
                            long long* __restrict__ stats, int grid,
                            int steps) {
  const volatile float* xv = x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < grid;
       g += gridDim.x * blockDim.x) {
    const float x0 = *xv;
    const long long t0 = clock64();
    float acc = 0.0f;
    for (int i = 0; i < steps; ++i)
      acc = __fadd_rn(__fmul_rn(acc, 1.000001f), x0);
    const long long t1 = clock64();
    out[g] = acc;
    stats[3 * g] = t1 - t0;
    stats[3 * g + 1] = steps;
    stats[3 * g + 2] = blockIdx.x;
  }
}

#ifdef LZ4T_PROBE_LATENCY
constexpr int kLatWords = 1024;              // the LDS chain's ring

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// SM cycles of n steps x = step(x)
template <typename T, typename F>
__device__ __forceinline__ long long timed(T& x, int n, F step) {
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = step(x);
  return clock64() - t0;
}

// SM cycles of n steps of a chain: a chain of 2n steps less one of n,
// so the clock reads and the loop's entry and exit cancel
template <typename T, typename F>
__device__ __forceinline__ long long price(T& x, int n, F step) {
  const long long once = timed(x, n, step);
  return timed(x, 2 * n, step) - once;
}

// One warp: lane 0 prices each class's chain in turn (see the header);
// y and z are 1 and 0x9e3779b9 from the host, so nvcc cannot fold them.
__global__ void __launch_bounds__(32)
    latency_kernel(const unsigned long long* l1, int l1_len,
                   const unsigned long long* l2, int l2_len,
                   uint32_t* __restrict__ sink, long long* __restrict__ st,
                   int steps, uint32_t y, uint32_t z) {
  __shared__ uint32_t s[kLatWords];
  for (int i = threadIdx.x; i < kLatWords; i += 32)
    s[i] = ((i + 97) & (kLatWords - 1)) * 4;   // byte offset of the next
  __syncwarp();
  const bool lead = threadIdx.x == 0;
  const long long c_start = clock64(), g_start = globaltimer();
  const auto next = [](const unsigned long long* q) {
    return reinterpret_cast<const unsigned long long*>(__ldg(q));
  };
  if (lead) {
    const char* sb = reinterpret_cast<const char*>(s);
    uint32_t p = 0;
    st[0] = price(p, steps, [&](uint32_t v) {
      return *reinterpret_cast<const uint32_t*>(sb + v);
    });
    st[1] = steps;
    sink[0] = p;

    const unsigned long long* q = l1;
    timed(q, l1_len, next);                      // the ring into L1
    st[2] = price(q, steps, next);
    st[3] = steps;
    sink[1] = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(q));

    q = l2;
    timed(q, l2_len, next);    // the ring into L2, and out of L1 again
    st[4] = price(q, steps, next);        // 3 * steps < l2_len loads
    st[5] = steps;
    sink[2] = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(q));

    uint32_t x = z;                              // LOP3, IADD3, LOP3
    st[6] = price(x, steps,
                  [&](uint32_t v) { return (v + y + (v & 3)) & z; });
    st[7] = 3ll * steps;
    sink[3] = x;

    x = z;
    st[8] = price(x, steps, [&](uint32_t v) { return v * (y + 2) + z; });
    st[9] = steps;
    sink[4] = x;

    float f = static_cast<float>(y);
    const float a = 1.000001f * static_cast<float>(y);
    st[10] = price(f, steps, [&](float v) {
      return __fadd_rn(__fmul_rn(v, a), 0.5f);
    });
    st[11] = 2ll * steps;
    sink[5] = __float_as_uint(f);
  }
  __syncwarp();
  uint32_t v = threadIdx.x * z;
  const long long t = price(v, steps, [](uint32_t w) {
    return __shfl_xor_sync(0xffffffffu, w, 1);
  });
  if (lead) {
    sink[6] = v;
    st[12] = t, st[13] = steps;
    st[14] = clock64() - c_start, st[15] = globaltimer() - g_start;
  }
}
#endif

std::atomic<unsigned long long> g_raised{0};

}  // namespace

// Variants 0-5: words int32[B, words_per_row] (words_per_row <= 16640),
// ns int32[B], out int32[B], stats int64[grid, 2]; `steps` is variant
// e's count. Variants 6-7: words is x float32[1], out float32[grid],
// stats int64[grid, 3], `steps` the burn loop's count. Variant 8 (the
// latency build only): words and ns the L1 and L2 rings (int64[B] and
// int64[words_per_row]), out uint32[8], stats int64[8, 2], `steps` each
// chain's length. Returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_probe_walk(const void* words, const void* ns, void* out,
                               void* stats, int B, int words_per_row,
                               int grid, int variant, int steps,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef LZ4T_PROBE_LATENCY
  if (variant == 8) {
    latency_kernel<<<1, 32, 0, st>>>(
        static_cast<const unsigned long long*>(words), B,
        static_cast<const unsigned long long*>(ns), words_per_row,
        static_cast<uint32_t*>(out), static_cast<long long*>(stats), steps,
        1u, 0x9e3779b9u);
    return static_cast<int>(cudaGetLastError());
  }
#endif
  if (grid <= 0) return 0;
  if (variant == 6 || variant == 7) {
    // arbitrary: one CTA, a grid step a thread; parallel: a CTA a step
    const int threads = variant == 6 ? (grid < 1024 ? grid : 1024) : 1;
    burn_kernel<<<variant == 6 ? 1 : grid, threads, 0, st>>>(
        static_cast<const float*>(words), static_cast<float*>(out),
        static_cast<long long*>(stats), grid, steps);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant < 0 || variant > 5 || B <= 0 || words_per_row <= 0 ||
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
