// P1: the gather probes over a block of R x C int32 words (64 K words,
// 256 KB, in the probe's (512, 128)).
//
// Replaces: tools/pallas_probe.py : k_lane (:78), k_flat (:89), k_row
// (:103), k_chase (:115) and k_hops (:134), all through its `call`
// (pl.pallas_call, :64), vmapped over B blocks.
//
// On the TPU a whole block sat in VMEM. A block of 256 KB is more than
// one CTA's 227 KB of shared memory, so each body reads where its reach
// allows:
//   0 lane:  out[r, c] = x[r, idx[r, c] mod C]. Row-local: a CTA takes
//            `rows_per_cta` whole rows (32 KB) into shared memory and
//            gathers from there;
//   1 flat:  out[r, c] = x.flat[idx[r, c] mod N]. Reaches the whole
//            block: read from global memory through L1/L2 (__ldg), one
//            output word a thread;
//   2 row:   out[r, c] = x[idx[r, c] mod R, c]. Column-local: a CTA
//            takes `cols_per_cta` whole columns (32 KB) into shared
//            memory and gathers from there;
//   3 chase: `steps` rounds (8 in the probe) of ptr = where(ptr >= 0,
//            ptr[clip(ptr, 0, N - 1)], ptr) over the whole block. Each
//            round reads the last round's whole block, so one CTA of
//            1024 threads takes a block, ping-ponging between `out` and
//            `scratch` in global memory (L1/L2) with a barrier a round;
//   4 hops:  one thread a block, `steps` (8192) dependent steps of
//            out[k] = cur; cur = nm[min(cur + ml[cur], N - 1)], the
//            serial parse pattern on global memory (L1/L2). cur + ml is
//            taken without wrapping (in 64 bits) and every index mod N.
// Index semantics: the TPU's gathers wrap an index out of range (mod the
// gathered extent); the port takes that, with R and C powers of two, so
// mod is a mask and equals the floor mod of a negative index.
//
// What bounds them: lane, flat and row move 12 bytes a word (index and
// source in, result out), 3.1 MB for the probe's 32 blocks, 0.94 us at
// 3.35 TB/s; chase's rounds and hops' steps are dependent loads, so
// latency bounds them. stats[b] = (SM cycles, chain steps) of chase's
// and hops' chains (thread 0 of the block's CTA).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChaseThreads = 1024;
constexpr int kShareWords = 8192;   // a CTA's share: 32 KB, under the 48 KB
                                    // a launch may take without a raise

__global__ void __launch_bounds__(kThreads)
    lane_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                int C, int rows_per_cta) {
  extern __shared__ int32_t s[];
  const int words = rows_per_cta * C;
  const size_t base = static_cast<size_t>(blockIdx.x) * words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int col = idx[base + i] & (C - 1);
    out[base + i] = s[(i & ~(C - 1)) + col];
  }
}

__global__ void __launch_bounds__(kThreads)
    row_kernel(const int32_t* __restrict__ x,
               const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int R, int C, int cols_per_cta) {
  extern __shared__ int32_t s[];
  const int parts = C / cols_per_cta;
  const int b = blockIdx.x / parts;
  const int c0 = (blockIdx.x % parts) * cols_per_cta;
  const size_t blk = static_cast<size_t>(b) * R * C;
  const int words = R * cols_per_cta;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int r = i / cols_per_cta, cl = i % cols_per_cta;
    s[i] = x[blk + static_cast<size_t>(r) * C + c0 + cl];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int r = i / cols_per_cta, cl = i % cols_per_cta;
    const size_t at = blk + static_cast<size_t>(r) * C + c0 + cl;
    const int j = idx[at] & (R - 1);
    out[at] = s[j * cols_per_cta + cl];
  }
}

__global__ void __launch_bounds__(kThreads)
    flat_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                int N, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += stride) {
    const long long blk = e & ~static_cast<long long>(N - 1);
    out[e] = __ldg(x + blk + (__ldg(idx + e) & (N - 1)));
  }
}

// Buffers written inside the launch are read with plain loads: the
// barrier at the end of each round makes one round's writes visible to
// the whole CTA.
__global__ void __launch_bounds__(kChaseThreads)
    chase_kernel(const int32_t* __restrict__ p, int32_t* out,
                 int32_t* scratch, long long* __restrict__ stats, int N,
                 int rounds) {
  const size_t blk = static_cast<size_t>(blockIdx.x) * N;
  const int32_t* cur = p + blk;
  int32_t* o = out + blk;
  int32_t* sc = scratch + blk;
  const long long t0 = clock64();
  if (rounds <= 0)
    for (int i = threadIdx.x; i < N; i += blockDim.x) o[i] = cur[i];
  for (int r = 0; r < rounds; ++r) {
    int32_t* dst = ((rounds - 1 - r) & 1) ? sc : o;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int32_t v = cur[i];
      const int32_t c = v < 0 ? 0 : (v > N - 1 ? N - 1 : v);
      const int32_t nx = cur[c];
      dst[i] = v >= 0 ? nx : v;
    }
    __syncthreads();
    cur = dst;
  }
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = clock64() - t0;
    stats[2 * blockIdx.x + 1] = rounds > 0 ? rounds : 0;
  }
}

__global__ void hops_kernel(const int32_t* __restrict__ nm,
                            const int32_t* __restrict__ ml,
                            int32_t* __restrict__ out,
                            long long* __restrict__ stats, int N,
                            int steps) {
  const size_t blk = static_cast<size_t>(blockIdx.x) * N;
  const int32_t* nmb = nm + blk;
  const int32_t* mlb = ml + blk;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * steps;
  const unsigned long long mask = static_cast<unsigned long long>(N - 1);
  int32_t cur = 0;
  const long long t0 = clock64();
  for (int k = 0; k < steps; ++k) {
    o[k] = cur;
    const int32_t step = __ldg(mlb + (static_cast<uint32_t>(cur) & mask));
    long long lin = static_cast<long long>(cur) + step;
    if (lin > N - 1) lin = N - 1;
    cur = __ldg(nmb + (static_cast<unsigned long long>(lin) & mask));
  }
  stats[2 * blockIdx.x] = clock64() - t0;
  stats[2 * blockIdx.x + 1] = steps;
}

int share(int extent, int other) {
  int k = kShareWords / other;
  if (k < 1) k = 1;
  return k < extent ? k : extent;
}

}  // namespace

// a, b: int32[B, R, C] (x and idx; chase: p and unused; hops: nm and
// ml); out: int32[B, R, C] (hops: int32[B, steps]); scratch: int32[B, R,
// C] for chase; stats: int64[B, 2] for chase and hops. R and C are
// powers of two. Returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_probe_gather(const void* a, const void* b, void* out,
                                 void* scratch, void* stats, int B, int R,
                                 int C, int variant, int steps,
                                 void* stream) {
  if (B <= 0) return 0;
  if (R <= 0 || C <= 0 || (R & (R - 1)) || (C & (C - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int32_t*>(a);
  const auto* y = static_cast<const int32_t*>(b);
  auto* o = static_cast<int32_t*>(out);
  const int N = R * C;
  switch (variant) {
    case 0: {
      const int rpc = share(R, C);
      lane_kernel<<<B * (R / rpc), kThreads, rpc * C * 4, st>>>(x, y, o, C,
                                                                rpc);
      break;
    }
    case 1: {
      const long long total = static_cast<long long>(B) * N;
      long long blocks = (total + kThreads - 1) / kThreads;
      if (blocks > 132 * 64) blocks = 132 * 64;
      flat_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(
          x, y, o, N, total);
      break;
    }
    case 2: {
      const int cpc = share(C, R);
      row_kernel<<<B * (C / cpc), kThreads, R * cpc * 4, st>>>(x, y, o, R, C,
                                                               cpc);
      break;
    }
    case 3:
      chase_kernel<<<B, kChaseThreads, 0, st>>>(
          x, o, static_cast<int32_t*>(scratch),
          static_cast<long long*>(stats), N, steps);
      break;
    case 4:
      hops_kernel<<<B, 1, 0, st>>>(x, y, o, static_cast<long long*>(stats),
                                    N, steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
