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
// extent.
//
// The gathers (0-2) spread their output over the card: one thread writes
// 4 consecutive words of a row, rows * 128 / 4 / 256 CTAs of 256 threads
// (1 at 8 rows, 64 at 512, 4096 at 32,768). A thread loads its 4 indices
// with one 16-byte load, reads the 4 source words with independent
// __ldg loads and stores its 4 results with one 16-byte store; where idx
// or out is not 16-byte aligned (a view at an odd storage offset) the
// launcher picks the instantiation with 4-byte loads and stores. They
// launch through the library's Python entry (pyentry.h), which checks,
// allocates the output and launches in one C call. Nothing is staged: src
// is 4 KB to 16 MB (4-256 KB at the tool's 8-512 rows) and stays in L1/L2
// after its first touch, so no CTA waits at a barrier.
//
// The loops (10-15) and the wave (20) measure latency floors of one
// lane's dependent steps, so they keep a lane's column in shared memory:
// the 128 lanes are split over CTAs until a CTA's columns fit, L =
// min(128, 32768 / rows) lanes a CTA (128 KB at most: (512, 128) is 2
// CTAs of 64 lanes, (4096, 128) 16 CTAs of 8). Each CTA also keeps its
// own copy of the 4 KB src[:8, :], which the axis-1 and two-step steps
// read across lanes. One thread carries one lane: its 8 rows in
// registers.
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
// What bounds them: the gathers move 12 bytes a word (idx and src in, out
// out): 12 KB at 8 rows, 0.77 MB at 512, a few microseconds of launch and
// one pass over the card at most, so the host's call dominates. The loops
// and the wave are latency-bound: a step is a dependent shared-memory
// load (or 512 of them for onehot) and some ALU; the bytes are 4 KB to
// 2 MB read once and 4 KB written. stats[cta] = (SM cycles of thread 0's
// loop, steps).

#include "pyentry.h"  // first: Python.h precedes the system headers

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kShareWords = 32768;          // 128 KB of a CTA's columns
constexpr int kS8Words = 8 * kLanes;
constexpr int kMaxSmem = (kShareWords + kS8Words) * 4;
constexpr int kLoadThreads = 256;
constexpr int kGatherThreads = 256;
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

// s8[(w >> 7) mod 8, w mod 128] (two_step at one lane)
__device__ __forceinline__ uint32_t two_step(const uint32_t* s8, uint32_t w) {
  return s8[((w >> 7) & 7) * kLanes + (w & (kLanes - 1))];
}

__device__ __forceinline__ uint32_t asr(uint32_t x, int sh) {
  return static_cast<uint32_t>(static_cast<int32_t>(x) >> sh);
}

// words [e, e + 4) of p, with one 16-byte access (kVec) or four
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* p, int32_t (&v)[4]) {
  if (kVec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(p + k);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* p, const int32_t (&v)[4]) {
  if (kVec) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = v[k];
  }
}

// Variant V (0 a0, 1 a1, 2 2step) over 4 consecutive words a thread.
template <int V, bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int rows) {
  const int g = blockIdx.x * kGatherThreads + threadIdx.x;
  if (g >= rows * (kLanes / 4)) return;
  const int e = 4 * g;                          // the thread's first word
  const int r = e / kLanes, c = e % kLanes;
  int32_t w[4];
  load4<kVec>(idx + (V == 2 ? c : e), w);       // 2step: row 0's words
  int32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = static_cast<uint32_t>(w[k]);
    int at;
    if (V == 0)
      at = static_cast<int>(u & (rows - 1)) * kLanes + c + k;
    else if (V == 1)
      at = r * kLanes + static_cast<int>(u & (kLanes - 1));
    else
      at = static_cast<int>(((u >> 7) & 7) * kLanes + (u & (kLanes - 1)));
    v[k] = __ldg(src + at);
  }
  store4<kVec>(out + e, v);
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

std::atomic<unsigned long long> g_raised[7];

// each kernel (and instantiation) raises its own limit once a device
template <typename K>
int raise_smem(K kernel, int slot) {
  return static_cast<int>(
      lz4t::allow_smem(kernel, kMaxSmem, g_raised[slot]));
}

template <int V>
void launch_gather(const int32_t* src, const int32_t* idx, int32_t* out,
                   int rows, cudaStream_t st) {
  const int grid = rows * (kLanes / 4) / kGatherThreads;
  const bool vec = !((reinterpret_cast<uintptr_t>(idx) |
                      reinterpret_cast<uintptr_t>(out)) & 15);
  if (vec)
    gather_kernel<V, true><<<grid, kGatherThreads, 0, st>>>(src, idx, out,
                                                             rows);
  else
    gather_kernel<V, false><<<grid, kGatherThreads, 0, st>>>(src, idx, out,
                                                              rows);
}

// The Python entry's gathers (pyentry.h): src and idx int32[rows, 128],
// rows a power of two in [8, 32768], 8 for a1 and 2step.
bool gather_valid(const long long* shape, int ndim, int code) {
  const long long rows = shape[0];
  return ndim == 2 && shape[1] == kLanes && rows >= 8 &&
         rows <= kShareWords && !(rows & (rows - 1)) && code >= 0 &&
         code <= 2 && (code == 0 || rows == 8);
}

int gather_launch(const long long* shape, int, const void* src,
                  const void* idx, void* out, int code, cudaStream_t st) {
  const auto* s = static_cast<const int32_t*>(src);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const int rows = static_cast<int>(shape[0]);
  if (code == 0)
    launch_gather<0>(s, ix, o, rows, st);
  else if (code == 1)
    launch_gather<1>(s, ix, o, rows, st);
  else
    launch_gather<2>(s, ix, o, rows, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LZ4T_GATHER_MODULE(lz4t_probe_lane, gather_valid, gather_launch,
                   "probe_lane gather")

// The loops (10-15) and the wave (20); the gathers launch through the
// Python entry above. src: int32[rows, 128]; out: int32[8, 128]; stats:
// int64[ctas, 2] (ctas = 128 / lanes_per_cta(rows), 512 rows for 20).
// Returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_probe_lane(const void* src, void* out, void* stats,
                               int rows, int variant, int nit,
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
    if ((e = raise_smem(loop_kernel<V>, SLOT))) return e;                  \
    loop_kernel<V><<<grid, threads, smem, st>>>(s, o, stt, rows, nit);     \
    break;
    LZ4T_LOOP(10, 0)
    LZ4T_LOOP(11, 1)
    LZ4T_LOOP(12, 2)
    LZ4T_LOOP(13, 3)
    LZ4T_LOOP(14, 4)
    LZ4T_LOOP(15, 5)
#undef LZ4T_LOOP
    case 20:
      if ((e = raise_smem(wave_kernel, 6))) return e;
      wave_kernel<<<grid, threads, smem, st>>>(s, o, stt, nit);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
