// P4: the per-lane gathers of a 128-lane wavefront decoder, and its mock
// row step.
//
// Replaces: tools/session_r4probe2.py : kern (:81, call :85, the
// correctness gathers), the loop kernels of mk_loop (:178, call :151)
// with the bodies b_base (:191), b_a0_8 (:197), b_a1_8 (:204), b_2step
// (:211), mk_a0_big (:218) and b_onehot (:233), and wave_kern (:248,
// call :278).
//
// On the TPU a (rows, 128) int32 array is 128 lanes; take_along_axis
// along axis 0 gathers within each lane (tpu.dynamic_gather), along axis
// 1 across the lanes of a row, and both wrap an index mod the gathered
// extent. Every axis-0 gather here is lane-local, so the 128 lanes are
// split over CTAs until a CTA's columns fit in shared memory: L = min(128,
// 32768 / rows) lanes a CTA (128 KB at most: (512, 128) is 2 CTAs of 64
// lanes, (4096, 128) 16 CTAs of 8). Each CTA also keeps its own copy of
// the 4 KB src[:8, :], which the axis-1 and two-step gathers read across
// lanes. One thread carries one lane: its 8 rows in registers.
//
// Variants (`variant`; rows a power of two, 8 for 1, 2, 10-13 and 20):
//   0 a0:    out[r, c] = src[idx[r, c] mod rows, c];
//   1 a1:    out[r, c] = src[r, idx[r, c] mod 128];
//   2 2step: out[r, c] = src[(w >> 7) mod 8, w mod 128], w = idx[0, c]
//            (floor division and floor mod, as jnp's // and %);
//   10-15 the loop kernel over `nit` steps, acc = src[:8, :] at first,
//         then acc = body(acc, i): 10 base, 11 a0_8, 12 a1_8, 13 2step,
//         14 a0_big (rows 64, 512, 4096 in the probe), 15 onehot (a
//         one-hot multiply and a sum over the rows, rows 512);
//   20 wave: wave_kern's mock row step over `nit` steps with a 512-row
//         history per lane. The TPU's scratch starts undefined (the
//         interpreter reads INT32_MIN); the port zero-fills it.
// Bodies 13-15 and 20 index with row 0 of acc only (the probe broadcasts
// it), so their gathered word is the same for the 8 rows. Integer
// arithmetic is uint32 (jnp's int32 wraps; signed overflow is undefined
// in C++), floor mod of a power of two is a mask, and >> of an int32 is
// arithmetic, as in jnp.
//
// What bounds them: latency. A loop step is a dependent shared-memory
// load (or 512 of them for onehot) and some ALU; the bytes are 4 KB to
// 2 MB read once and 4 KB written. stats[cta] = (SM cycles of thread 0's
// loop, steps).

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kShareWords = 32768;          // 128 KB of a CTA's columns
constexpr int kS8Words = 8 * kLanes;
constexpr int kMaxSmem = (kShareWords + kS8Words) * 4;
constexpr int kLoadThreads = 256;
constexpr int kWaveRows = 512;

__host__ __device__ inline int lanes_per_cta(int rows) {
  int L = kShareWords / rows;
  if (L < 1) L = 1;
  return L < kLanes ? L : kLanes;
}

// src[:, lane0 : lane0 + L] into s (rows x L) and src[:8, :] into s8
__device__ inline void load(const int32_t* src, uint32_t* s, uint32_t* s8,
                            int rows, int L, int lane0) {
  for (int i = threadIdx.x; i < kS8Words; i += blockDim.x)
    s8[i] = static_cast<uint32_t>(src[i]);
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int r = i / L, cl = i % L;
    s[i] = static_cast<uint32_t>(src[r * kLanes + lane0 + cl]);
  }
}

// out[r, c] = s8[(w >> 7) mod 8, w mod 128] (two_step at one lane)
__device__ __forceinline__ uint32_t two_step(const uint32_t* s8, uint32_t w) {
  return s8[((w >> 7) & 7) * kLanes + (w & (kLanes - 1))];
}

__device__ __forceinline__ uint32_t asr(uint32_t x, int sh) {
  return static_cast<uint32_t>(static_cast<int32_t>(x) >> sh);
}

__global__ void __launch_bounds__(kLoadThreads)
    gather_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int rows, int variant) {
  extern __shared__ uint32_t smem[];
  uint32_t* s8 = smem;
  uint32_t* s = smem + kS8Words;
  const int L = lanes_per_cta(rows);
  const int lane0 = blockIdx.x * L;
  load(src, s, s8, rows, L, lane0);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int r = i / L, cl = i % L, c = lane0 + cl;
    uint32_t v;
    if (variant == 0) {
      v = s[(idx[r * kLanes + c] & (rows - 1)) * L + cl];
    } else if (variant == 1) {
      v = s8[r * kLanes + (idx[r * kLanes + c] & (kLanes - 1))];
    } else {
      v = two_step(s8, static_cast<uint32_t>(idx[c]));
    }
    out[r * kLanes + c] = static_cast<int32_t>(v);
  }
}

template <int V>
__device__ inline void loop_body(const uint32_t* s, const uint32_t* s8,
                                 uint32_t (&acc)[8], uint32_t i, int rows,
                                 int L, int cl) {
  if (V == 10) {                                   // b_base
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= (acc[r] + i) & 7;
  } else if (V == 11) {                            // b_a0_8
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= s[((acc[r] + i) & 7) * L + cl];
  } else if (V == 12) {                            // b_a1_8
#pragma unroll
    for (int r = 0; r < 8; ++r)
      acc[r] ^= s8[r * kLanes + ((acc[r] + i) & (kLanes - 1))];
  } else if (V == 13) {                            // b_2step
    const uint32_t g = two_step(s8, (acc[0] + i) & 1023);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= g;
  } else if (V == 14) {                            // mk_a0_big
    const uint32_t g = s[((acc[0] + i) & (rows - 1)) * L + cl];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= g;
  } else {                                         // b_onehot
    const uint32_t at = (acc[0] + i) & (rows - 1);
    uint32_t g = 0;
    for (int r = 0; r < rows; ++r)
      g += static_cast<uint32_t>(r == static_cast<int>(at)) * s[r * L + cl];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= g;
  }
}

template <int V>
__global__ void __launch_bounds__(kLoadThreads)
    loop_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
                long long* __restrict__ stats, int rows, int nit) {
  extern __shared__ uint32_t smem[];
  uint32_t* s8 = smem;
  uint32_t* s = smem + kS8Words;
  const int L = lanes_per_cta(rows);
  const int lane0 = blockIdx.x * L;
  load(src, s, s8, rows, L, lane0);
  __syncthreads();
  const int cl = threadIdx.x;
  if (cl >= L) return;
  const int c = lane0 + cl;
  uint32_t acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = s8[r * kLanes + c];
  const long long t0 = clock64();
  for (int i = 0; i < nit; ++i)
    loop_body<V>(s, s8, acc, static_cast<uint32_t>(i), rows, L, cl);
  const long long t1 = clock64();
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * kLanes + c] = static_cast<int32_t>(acc[r]);
  if (cl == 0) {
    stats[2 * blockIdx.x] = t1 - t0;
    stats[2 * blockIdx.x + 1] = nit;
  }
}

__global__ void __launch_bounds__(kLoadThreads)
    wave_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
                long long* __restrict__ stats, int nit) {
  extern __shared__ uint32_t smem[];
  uint32_t* s8 = smem;
  uint32_t* hist = smem + kS8Words;             // kWaveRows x L
  const int L = lanes_per_cta(kWaveRows);
  const int lane0 = blockIdx.x * L;
  for (int i = threadIdx.x; i < kS8Words; i += blockDim.x)
    s8[i] = static_cast<uint32_t>(src[i]);
  for (int i = threadIdx.x; i < kWaveRows * L; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int cl = threadIdx.x;
  if (cl >= L) return;
  const int c = lane0 + cl;
  uint32_t acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = s8[r * kLanes + c];
  const long long t0 = clock64();
  for (int ii = 0; ii < nit; ++ii) {
    const uint32_t i = static_cast<uint32_t>(ii);
    // comp fetch: two adjacent words of the 4 KB window
    const uint32_t w = (acc[0] + i) & 1023;
    const uint32_t g0 = two_step(s8, w);
    const uint32_t g1 = two_step(s8, (w + 1) & 1023);
    // parse ALU
    uint32_t t = g0;
#pragma unroll
    for (int sh = 4; sh <= 20; sh += 4) {
      t ^= asr(g1, sh) & 255;
      t += asr(g0, sh) & 15;
      t = (t & 1) ? t + g1 : t - g0;
    }
    // near-window match gather from the lane's history
    const uint32_t mg = hist[((t + i) & (kWaveRows - 1)) * L + cl];
    uint32_t v = (t & 2) ? mg : g0;
    v = (v << 8) | (mg & 255);
    v ^= g1 & t;
    hist[(i & (kWaveRows - 1)) * L + cl] = v;     // dense row store
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] ^= v;
  }
  const long long t1 = clock64();
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * kLanes + c] = static_cast<int32_t>(acc[r]);
  if (cl == 0) {
    stats[2 * blockIdx.x] = t1 - t0;
    stats[2 * blockIdx.x + 1] = nit;
  }
}

std::atomic<unsigned long long> g_raised[8];

// each kernel (and instantiation) raises its own limit once a device
template <typename K>
int raise_smem(K kernel, int slot) {
  return static_cast<int>(
      lz4t::allow_smem(kernel, kMaxSmem, g_raised[slot]));
}

}  // namespace

// src: int32[rows, 128]; idx: int32[rows, 128] (variants 0-2); out:
// int32[rows, 128] (0-2) or int32[8, 128] (10-15, 20); stats:
// int64[ctas, 2] (10-15, 20; ctas = 128 / lanes_per_cta(rows), 512 rows
// for 20). Returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_probe_lane(const void* src, const void* idx, void* out,
                               void* stats, int rows, int variant, int nit,
                               void* stream) {
  if (rows < 8 || rows > kShareWords || (rows & (rows - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(src);
  auto* o = static_cast<int32_t*>(out);
  auto* stt = static_cast<long long*>(stats);
  const int body_rows = variant == 20 ? kWaveRows : rows;
  const int L = lanes_per_cta(body_rows);
  const int grid = kLanes / L;
  const int smem = (kS8Words + body_rows * L) * 4;
  const int threads = kLoadThreads;
  int e = 0;
  switch (variant) {
#define LZ4T_LOOP(V, SLOT)                                                  \
  case V:                                                                  \
    if ((e = raise_smem(loop_kernel<V>, SLOT))) return e;      \
    loop_kernel<V><<<grid, threads, smem, st>>>(s, o, stt, rows, nit);     \
    break;
    LZ4T_LOOP(10, 1)
    LZ4T_LOOP(11, 2)
    LZ4T_LOOP(12, 3)
    LZ4T_LOOP(13, 4)
    LZ4T_LOOP(14, 5)
    LZ4T_LOOP(15, 6)
#undef LZ4T_LOOP
    case 0:
    case 1:
    case 2:
      if ((e = raise_smem(gather_kernel, 0))) return e;
      gather_kernel<<<grid, threads, smem, st>>>(
          s, static_cast<const int32_t*>(idx), o, rows, variant);
      break;
    case 20:
      if ((e = raise_smem(wave_kernel, 7))) return e;
      wave_kernel<<<grid, threads, smem, st>>>(s, o, stt, nit);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
