// P1: the gather probes over a block of R x C int32 words (64 K words,
// 256 KB, in the probe's (512, 128)).
//
// Replaces: tools/pallas_probe.py : k_lane (:78), k_flat (:89), k_row
// (:103), k_chase (:115) and k_hops (:134), all through its `call`
// (pl.pallas_call, :64), vmapped over B blocks.
//
// On the TPU a whole block sat in VMEM. On Hopper the three gathers
// stream: a thread takes 4 consecutive words (a warp 128 words, 512 B),
// loads their indices with one 16-byte load and stores its 4 results with
// one 16-byte store. They launch through the library's Python entry
// (pyentry.h), which checks, allocates the output and launches in one C
// call; chase and hops through lz4t_probe_gather below:
//   0 lane:  out[r, c] = x[r, idx[r, c] mod C]. Row-local. Where C <= 128
//            a warp's 128 words are whole rows: the warp stages them from
//            x with one 16-byte load a lane into its own 512 B of shared
//            memory, waits at __syncwarp, and gathers from there
//            (`lane_kernel`). Longer rows gather from global memory
//            (`direct_kernel`), the row in L1/L2;
//   1 flat:  out[r, c] = x.flat[idx[r, c] mod N]. Reaches the whole
//            block. Where 1024 <= N <= 65536 a CTA holds the indices of
//            16,384 outputs (all N if fewer) and streams the block's x
//            through two 64 KB buffers of shared memory with cp.async,
//            resolving in each pass the words whose source lies in the
//            piece that landed (`flat_kernel`); other N take
//            `direct_kernel`, the 4 source words of a thread as
//            independent __ldg loads through L1/L2, issued together;
//   2 row:   out[r, c] = x[idx[r, c] mod R, c]. Column-local, and each
//            word of a warp's 128 comes from another row. Where C >= 4 and
//            R * min(C, 32) <= 16384 a CTA copies a strip of 32 columns
//            (128 B a row) over all R rows into shared memory with
//            cp.async while it loads the strip's indices, then waits at
//            one barrier and gathers from there (`row_kernel`); other
//            shapes take `direct_kernel` as flat;
//   3 chase: `steps` rounds (8 in the probe) of ptr = where(ptr >= 0,
//            ptr[clip(ptr, 0, N - 1)], ptr) over the whole block. Each
//            round reads the last round's whole block. Where the block
//            fits a thread-block cluster's shared memory (32 <= N <=
//            131072: `chase_cluster`), a cluster of 8 CTAs takes a block,
//            each CTA N / 8 words of it as `cur` and `dst` (128 KB at
//            most), and a round gathers from the cluster's distributed
//            shared memory with one cluster barrier a round
//            (`chase_cluster_kernel`). Other N take one CTA of 1024
//            threads a block, ping-ponging between `out` and `scratch` in
//            global memory through L2 with a barrier a round
//            (`chase_kernel`);
//   4 hops:  one thread a block, `steps` (8192) dependent steps of
//            out[k] = cur; cur = nm[min(cur + ml[cur], N - 1)], the
//            serial parse pattern on global memory (L1/L2). cur + ml is
//            taken without wrapping (in 64 bits) and every index mod N.
// A view may start at any 4-byte offset: where a pointer that a kernel
// reads or writes 16 bytes at a time is not 16-byte aligned, the launcher
// picks the instantiation with 4-byte loads and stores (kVec false).
// Index semantics: the TPU's gathers wrap an index out of range (mod the
// gathered extent); the port takes that, with R and C powers of two, so
// mod is a mask and equals the floor mod of a negative index.
//
// What bounds them: lane, flat and row move 12 bytes a word (index and
// source in, result out), 25.2 MB for the probe's 32 blocks of 65,536
// words, 7.5 us at 3.35 TB/s. The working set fits the 50 MB L2, so only
// a launch behind an L2 flush reads it from HBM. Covering HBM's latency
// at that rate takes some 18 KB in flight a SM (3.35 TB/s / 132 SMs x
// ~700 ns). lane_kernel: at 32 registers a thread, 8 CTAs of 256 threads
// are resident a SM, 2048 threads that each hold 16 B of index and 16 B
// of x in flight, 64 KB a SM; row_kernel holds its 64 KB strip and 64 KB
// of indices in flight at once, flat_kernel 64 KB of indices and a 64 KB
// piece. direct_kernel reads x a word at a time at random, so each
// 4-byte read brings a 32-byte sector from L2: at the probe's size some
// 64 MB of L2 traffic for 8 MB of x, which flat_kernel replaces with 32 MB
// read in 64 KB runs.
// hops' steps are dependent loads, so latency bounds it: it visits 12
// bytes a step, 3.1 MB for 32 blocks of 8192 steps, 0.94 us at 3.35 TB/s.
// chase moves 8 bytes a word once (16.8 MB in and out for the probe's 32
// blocks); its rounds' loads and gathers, each reading only the last
// round's words, are what bound it. On one SM a block's 8 rounds take at
// least some 46,000 cycles of L1 traffic (`gather_probe.chase_throughput`)
// and leave 131 SMs idle; in global memory each word of a round is a
// coalesced load, a dependent gather from L2 and a store. The cluster
// spreads a block over 8 CTAs on up to 8 SMs and keeps every round in
// shared memory: the block is loaded once (bulk copies) and stored once.
// Its remote gathers (generic loads of the cluster's shared window, 7 in
// 8 of them to another SM) then take most of the first rounds' cycles
// (PERF.md, P1 k_chase).
// stats[b] = (SM cycles, chain steps) of chase's and hops' chains: hops'
// thread, chase's CTA (thread 0; the most of the cluster's CTAs' clocks
// on the cluster body).

#include "pyentry.h"  // first: Python.h precedes the system headers

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mbarrier.cuh"
#include "smem.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kChaseThreads = 1024;  // chase's global-memory body's CTA
constexpr int kChaseStage = 16;      // words a chase thread holds a round
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * 4;       // a warp's words: 4 a lane
constexpr long long kMaxGrid = 1 << 20;
constexpr int kStripCols = 32;      // a row strip's width: 128 B a row
constexpr int kStripWords = 16384;  // a strip's x: 64 KB of shared memory
constexpr int kStripGroups = kStripWords / 4 / kThreads;  // 16 a thread
constexpr int kFlatThreads = 512;
constexpr int kPieceWords = 16384;  // flat_kernel's piece of x: 64 KB
constexpr int kFlatMinWords = 1024;            // N that flat_kernel takes
constexpr int kFlatMaxWords = 65536;
constexpr int kFlatGroups = kPieceWords / 4 / kFlatThreads;  // 8 a thread
constexpr int kMaxSmem = 2 * kPieceWords * 4;  // two pieces; a strip fits
static_assert(kStripWords * 4 <= kMaxSmem, "a strip fits");
// chase's cluster body: kCluster CTAs a block (the portable cluster
// size), each holding N / kCluster words twice (cur, dst), at most
// kCtaWords (2 x 64 KB). At 4 CTAs a block the probe's 32 blocks of
// 65,536 words would need 128 KB a CTA, one CTA a SM, and only 30 such
// clusters are resident at once (the GPCs' SM counts): two waves. At 8,
// with 512 threads held to 40 registers, three 64 KB CTAs fit a SM and 45
// clusters are resident: one wave, faster in turns than 4 (PERF.md,
// P1 k_chase)
constexpr int kCtaWords = 16384;
constexpr int kCluster = 8;
constexpr int kClusterThreads = 512;   // a cluster CTA's most threads
constexpr int kBulkBytes = 16384;      // a bulk copy's bytes
static_assert(2 * kCtaWords * 4 <= kMaxSmem, "a CTA's words fit");

// words [0, 4) of p, with one 16-byte access (kVec) or four
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

// lane with C <= 128: a warp's tile of 128 words is whole rows (tiles
// start at multiples of 128, and total is a multiple of C), staged in the
// warp's 512 B of shared memory. The last tile may be short.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    lane_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                long long total, int C) {
  __shared__ __align__(16) int32_t stage[kWarps][kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* s = stage[warp];
  const long long tiles = (total + kTile - 1) / kTile;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
       t < tiles; t += static_cast<long long>(gridDim.x) * kWarps) {
    const long long e = t * kTile + 4 * lane;
    const long long left = total - e;
    const int n = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
    int32_t xv[4] = {0, 0, 0, 0}, w[4] = {0, 0, 0, 0};
    if (n == 4) {
      load4<kVec>(x + e, xv);
      load4<kVec>(idx + e, w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) xv[k] = __ldg(x + e + k), w[k] = __ldg(idx + e + k);
    }
    __syncwarp();                       // the last tile's reads are done
    if (n == 4) {
      store4<kVec>(s + 4 * lane, xv);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) s[4 * lane + k] = xv[k];
    }
    __syncwarp();
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;       // rows of the tile are whole
      v[k] = k < n ? s[(i & ~(C - 1)) + (w[k] & (C - 1))] : 0;
    }
    if (n == 4) {
      store4<kVec>(out + e, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) out[e + k] = v[k];
    }
  }
}

// row where C >= 4 and R * W <= 16384, W = min(C, 32): a CTA takes a
// strip, the columns [c0, c0 + W) of one block over all R rows (64 KB at
// most), and copies it into shared memory with cp.async, 16 bytes a copy
// (kVec) or 4. While the copies fly, each thread loads the indices of all
// its 4-word groups (16 at most: R * W / 4 / 256), so a SM holds the
// strip and its indices, 128 KB, in flight at once; then one barrier, and
// out[r, c] = s[idx[r, c] mod R][c - c0] with 16-byte stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    row_kernel(const int32_t* __restrict__ x,
               const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int R, int C, int W, long long strips) {
  extern __shared__ __align__(16) int32_t strip[];   // R x W
  const int q4 = W / 4;                                // groups a row
  const int groups = R * q4;
  const int parts = C / W;
  for (long long t = blockIdx.x; t < strips; t += gridDim.x) {
    const long long blk = t / parts * R * C;
    const int c0 = static_cast<int>(t % parts) * W;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      const int r = g / q4, q = g % q4;
      const int32_t* from = x + blk + static_cast<long long>(r) * C + c0 + 4 * q;
      int32_t* to = strip + r * W + 4 * q;
      if (kVec) {
        __pipeline_memcpy_async(to, from, 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) __pipeline_memcpy_async(to + k, from + k, 4);
      }
    }
    __pipeline_commit();
    int32_t w[kStripGroups][4];
#pragma unroll
    for (int j = 0; j < kStripGroups; ++j) {
      const int g = threadIdx.x + j * kThreads;
      if (g < groups)
        load4<kVec>(idx + blk + static_cast<long long>(g / q4) * C + c0 +
                        4 * (g % q4),
                    w[j]);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStripGroups; ++j) {
      const int g = threadIdx.x + j * kThreads;
      if (g < groups) {
        const int r = g / q4, q = g % q4;
        int32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = strip[(w[j][k] & (R - 1)) * W + 4 * q + k];
        store4<kVec>(out + blk + static_cast<long long>(r) * C + c0 + 4 * q,
                     v);
      }
    }
    __syncthreads();                    // the strip is read before the next
  }
}

// Piece [0, words) of x into shared memory with cp.async, 16 bytes a copy
// (kVec) or 4, as one commit group.
template <bool kVec>
__device__ __forceinline__ void copy_piece(int32_t* to, const int32_t* from,
                                           int words) {
  for (int g = threadIdx.x; g < words / 4; g += kFlatThreads) {
    if (kVec) {
      __pipeline_memcpy_async(to + 4 * g, from + 4 * g, 16);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        __pipeline_memcpy_async(to + 4 * g + k, from + 4 * g + k, 4);
    }
  }
  __pipeline_commit();
}

// flat where 1024 <= N <= 65536: a CTA takes a chunk of P = min(N, 16384)
// output words of one block and loads their indices (8 4-word groups a
// thread at most); the block's x then passes through its shared memory in
// N / P pieces of P words (64 KB at most), double-buffered with cp.async:
// while it resolves the words whose source lies in piece p, piece p + 1
// lands. x is read N / P times from L2 in 64 KB runs instead of a 32-byte
// sector a word.
template <bool kVec>
__global__ void __launch_bounds__(kFlatThreads)
    flat_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                int N, long long chunks) {
  extern __shared__ __align__(16) int32_t buf[];     // 2 pieces (1 if N = P)
  const int P = N < kPieceWords ? N : kPieceWords;    // a power of two
  const int lp = __ffs(P) - 1;
  const int pieces = N / P;
  const int groups = P / 4;
  for (long long t = blockIdx.x; t < chunks; t += gridDim.x) {
    const long long blk = t / pieces * N;
    const long long first = blk + t % pieces * P;     // the chunk's words
    copy_piece<kVec>(buf, x + blk, P);
    int32_t w[kFlatGroups][4] = {}, v[kFlatGroups][4] = {};
#pragma unroll
    for (int j = 0; j < kFlatGroups; ++j) {
      const int g = threadIdx.x + j * kFlatThreads;
      if (g < groups) load4<kVec>(idx + first + 4 * g, w[j]);
    }
    for (int p = 0; p < pieces; ++p) {
      if (p + 1 < pieces) {
        copy_piece<kVec>(buf + ((p + 1) & 1) * P, x + blk + (p + 1) * P, P);
        __pipeline_wait_prior(1);                     // piece p has landed
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const int32_t* s = buf + (p & 1) * P;
#pragma unroll
      for (int j = 0; j < kFlatGroups; ++j) {
        if (threadIdx.x + j * kFlatThreads < groups) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = w[j][k] & (N - 1);
            if ((u >> lp) == p) v[j][k] = s[u & (P - 1)];
          }
        }
      }
      __syncthreads();                    // read before it is refilled
    }
#pragma unroll
    for (int j = 0; j < kFlatGroups; ++j) {
      const int g = threadIdx.x + j * kFlatThreads;
      if (g < groups) store4<kVec>(out + first + 4 * g, v[j]);
    }
  }
}

// The word a gather reads for output word e with index w, V = 0 lane,
// 1 flat, 2 row; R = 1 << lr, C = 1 << lc, N = R * C.
template <int V>
__device__ __forceinline__ long long source_of(long long e, int32_t w, int lr,
                                               int lc) {
  const long long u = static_cast<uint32_t>(w);
  if (V == 0) return (e & ~((1ll << lc) - 1)) | (u & ((1ll << lc) - 1));
  if (V == 1)
    return (e & ~((1ll << (lr + lc)) - 1)) | (u & ((1ll << (lr + lc)) - 1));
  return (e & ~((1ll << (lr + lc)) - 1)) | ((u & ((1ll << lr) - 1)) << lc) |
         (e & ((1ll << lc) - 1));
}

// Any gather from global memory: 4 consecutive output words a thread, the
// 4 source loads independent; the last group may be short.
template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
    direct_kernel(const int32_t* __restrict__ x,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  long long total, int lr, int lc) {
  const long long groups = (total + 3) / 4;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = 4 * g;
    if (e + 4 <= total) {
      int32_t w[4], v[4];
      load4<kVec>(idx + e, w);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = __ldg(x + source_of<V>(e + k, w[k], lr, lc));
      store4<kVec>(out + e, v);
    } else {
      for (long long k = e; k < total; ++k)
        out[k] = __ldg(x + source_of<V>(k, __ldg(idx + k), lr, lc));
    }
  }
}

// chase in global memory (N outside the cluster body's cut, or every N
// in the -DLZ4T_CHASE_GLOBAL build): one CTA of 1024 threads a block, the
// rounds ping-ponging between out and scratch with a barrier a round.
// Every load, of p as of the buffers the launch rewrites, is ld.global.cg
// (L2; LDG.E.STRONG.GPU in the SASS): the read-only path (__ldg,
// LDG.E.CONSTANT) need not see this launch's own stores, even across a
// barrier. out and scratch carry no __restrict__ (they alias nothing, but
// they are written), so a thread stages kChaseStage words of a round in
// registers, their loads, then their gathers, then their stores: a
// batch's gathers are in flight together.
__global__ void __launch_bounds__(kChaseThreads)
    chase_kernel(const int32_t* p, int32_t* out, int32_t* scratch,
                 long long* __restrict__ stats, int N, int rounds) {
  const size_t blk = static_cast<size_t>(blockIdx.x) * N;
  const int32_t* cur = p + blk;
  int32_t* o = out + blk;
  int32_t* sc = scratch + blk;
  const long long t0 = clock64();
  if (rounds <= 0)
    for (int i = threadIdx.x; i < N; i += kChaseThreads)
      o[i] = __ldcg(cur + i);
  for (int r = 0; r < rounds; ++r) {
    int32_t* dst = ((rounds - 1 - r) & 1) ? sc : o;
    for (int i0 = threadIdx.x; i0 < N; i0 += kChaseThreads * kChaseStage) {
      int32_t w[kChaseStage];
#pragma unroll
      for (int k = 0; k < kChaseStage; ++k) {
        const int i = i0 + k * kChaseThreads;
        w[k] = i < N ? __ldcg(cur + i) : -1;
      }
#pragma unroll
      for (int k = 0; k < kChaseStage; ++k)
        if (w[k] >= 0) w[k] = __ldcg(cur + min(w[k], N - 1));
#pragma unroll
      for (int k = 0; k < kChaseStage; ++k) {
        const int i = i0 + k * kChaseThreads;
        if (i < N) dst[i] = w[k];
      }
    }
    __syncthreads();
    cur = dst;
  }
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = clock64() - t0;
    stats[2 * blockIdx.x + 1] = rounds > 0 ? rounds : 0;
  }
}

// chase where 32 <= N <= 131072 (`chase_cluster`): a cluster of K
// (kCluster) CTAs a block, CTA `rank` holding words [rank Q, rank Q + Q),
// Q = N / K, in shared memory as cur and dst. It loads them with bulk
// copies on an mbarrier, then waits at a cluster barrier, so every CTA's
// words have landed before any is read. A round, for each 16 words of a thread (4
// groups of 4, g0 + j * blockDim; Q / 16 threads, 512 at most): their 4
// 16-byte loads from cur, then a gather for each word v >= 0 from cur of
// rank clip(v) / Q (a generic load of the cluster's shared window, LD.E
// in the SASS; an LDS where that rank is the CTA's own), then 4 16-byte
// stores to dst. One cluster barrier (arrive.release, wait.acquire) a
// round puts a round's stores before the next round's reads and its reads
// before the next round's stores, and cur and dst swap. Both are shared
// memory the thread addresses itself, so nothing may alias. After the
// last round each CTA stores cur to out with 16-byte stores. Each CTA
// takes its clock64 delta; rank 0 writes the cluster's largest to stats
// after a barrier, and a last barrier keeps every CTA's shared memory
// until it has been read.
__global__ void __launch_bounds__(kClusterThreads, 3)
    chase_cluster_kernel(const int32_t* __restrict__ p,
                         int32_t* __restrict__ out,
                         long long* __restrict__ stats, int N,
                         int rounds) {
  extern __shared__ __align__(128) int32_t words[];   // cur, dst: Q each
  __shared__ __align__(8) uint64_t landed;
  __shared__ long long took;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const uint32_t rank = cluster.block_rank();
  const int Q = N / K, lq = __ffs(Q) - 1, groups = Q / 4;
  const int blk = blockIdx.x / K;
  const size_t first = static_cast<size_t>(blk) * N +
                       static_cast<size_t>(rank) * Q;
  const long long t0 = clock64();
  const uint32_t bar = lz4t::smem_addr(&landed);
  if (threadIdx.x == 0) {
    lz4t::bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    lz4t::bar_arrive_tx(bar, Q * 4);
    for (int off = 0; off < Q * 4; off += kBulkBytes)
      lz4t::bulk_copy(lz4t::smem_addr(words) + off, p + first + off / 4,
                      min(kBulkBytes, Q * 4 - off), bar);
  }
  lz4t::bar_wait(bar, 0);
  cluster.sync();
  int32_t* cur = words;
  int32_t* dst = words + Q;
  constexpr int kGroups = kChaseStage / 4;
  for (int r = 0; r < rounds; ++r) {
    for (int g0 = threadIdx.x; g0 < groups; g0 += blockDim.x * kGroups) {
      int32_t w[kGroups][4];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int g = g0 + j * blockDim.x;
        if (g < groups) {
          const int4 q = reinterpret_cast<const int4*>(cur)[g];
          w[j][0] = q.x, w[j][1] = q.y, w[j][2] = q.z, w[j][3] = q.w;
        }
      }
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        if (g0 + j * blockDim.x < groups) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // v < 0 clamps to N - 1 as unsigned: a valid address, not read
            const int32_t v = w[j][k];
            const unsigned c = min(static_cast<unsigned>(v),
                                   static_cast<unsigned>(N - 1));
            const unsigned at = c & (Q - 1), from = c >> lq;
            const int32_t* remote = cluster.map_shared_rank(cur + at, from);
            if (v >= 0) w[j][k] = from == rank ? cur[at] : *remote;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int g = g0 + j * blockDim.x;
        if (g < groups)
          reinterpret_cast<int4*>(dst)[g] =
              make_int4(w[j][0], w[j][1], w[j][2], w[j][3]);
      }
    }
    cluster.sync();
    int32_t* t = cur;
    cur = dst;
    dst = t;
  }
  for (int g = threadIdx.x; g < groups; g += blockDim.x)
    reinterpret_cast<int4*>(out + first)[g] =
        reinterpret_cast<const int4*>(cur)[g];
  if (threadIdx.x == 0) took = clock64() - t0;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    long long most = 0;
    for (int k = 0; k < K; ++k) {
      const long long c = *cluster.map_shared_rank(&took, k);
      most = c > most ? c : most;
    }
    stats[2 * blk] = most;
    stats[2 * blk + 1] = rounds > 0 ? rounds : 0;
  }
  cluster.sync();
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

std::atomic<unsigned long long> g_raised[5];

// each row_kernel and flat_kernel instantiation and chase_cluster_kernel
// raise their limit to 128 KB once a device
template <typename K>
int raise_smem(K kernel, int slot) {
  return static_cast<int>(
      lz4t::allow_smem(kernel, kMaxSmem, g_raised[slot]));
}

bool aligned16(const void* p) {
  return !(reinterpret_cast<uintptr_t>(p) & 15);
}

// chase's cluster size for a block of N words (a power of two):
// kCluster where each CTA holds 4 to kCtaWords words, else 0 (the
// global-memory body). gather_probe.chase_route is the same cut.
// -DLZ4T_CHASE_GLOBAL sends every N to the global-memory body.
int chase_cluster(int N) {
#ifdef LZ4T_CHASE_GLOBAL
  static_cast<void>(N);
  return 0;
#else
  return N >= 4 * kCluster && N <= kCluster * kCtaWords ? kCluster : 0;
#endif
}

// A cluster launch of chase_cluster_kernel: `blocks` clusters of K CTAs,
// each of N / K / 16 threads (32 to 512; 16 words a thread a pass) and
// 2 N / K words of dynamic shared memory
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1]{};
  ClusterLaunch(int blocks, int K, int N, cudaStream_t st) {
    const int Q = N / K, t = Q / kChaseStage;
    cfg.gridDim = dim3(blocks * K);
    cfg.blockDim = dim3(t < 32 ? 32 : (t > kClusterThreads ? kClusterThreads
                                                           : t));
    cfg.dynamicSmemBytes = 2 * Q * 4;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

int grid_of(long long items, int per_cta) {
  const long long g = (items + per_cta - 1) / per_cta;
  return static_cast<int>(g < kMaxGrid ? g : kMaxGrid);
}

template <int V>
void launch_direct(const int32_t* x, const int32_t* y, int32_t* o,
                   long long total, int lr, int lc, cudaStream_t st) {
  const int grid = grid_of((total + 3) / 4, kThreads);
  if (aligned16(y) && aligned16(o))
    direct_kernel<V, true><<<grid, kThreads, 0, st>>>(x, y, o, total, lr, lc);
  else
    direct_kernel<V, false><<<grid, kThreads, 0, st>>>(x, y, o, total, lr,
                                                       lc);
}

// lane (0), flat (1) or row (2) over x, idx int32[B, R, C]
int launch_stream(const int32_t* x, const int32_t* y, int32_t* o, int B,
                  int R, int C, int variant, cudaStream_t st) {
  const int N = R * C;
  const long long total = static_cast<long long>(B) * N;
  const int lr = __builtin_ctz(R), lc = __builtin_ctz(C);
  if (variant == 0 && C <= kTile) {
    const int grid = grid_of((total + kTile - 1) / kTile, kWarps);
    if (aligned16(x) && aligned16(y) && aligned16(o))
      lane_kernel<true><<<grid, kThreads, 0, st>>>(x, y, o, total, C);
    else
      lane_kernel<false><<<grid, kThreads, 0, st>>>(x, y, o, total, C);
  } else if (variant == 0) {
    launch_direct<0>(x, y, o, total, lr, lc, st);
  } else if (variant == 1 && N >= kFlatMinWords && N <= kFlatMaxWords) {
    const int P = N < kPieceWords ? N : kPieceWords;
    const long long chunks = static_cast<long long>(B) * (N / P);
    const int grid = static_cast<int>(chunks < kMaxGrid ? chunks : kMaxGrid);
    const int smem = (N > P ? 2 : 1) * P * 4;
    const bool vec = aligned16(x) && aligned16(y) && aligned16(o);
    const int e = vec ? raise_smem(flat_kernel<true>, 2)
                      : raise_smem(flat_kernel<false>, 3);
    if (e) return e;
    if (vec)
      flat_kernel<true><<<grid, kFlatThreads, smem, st>>>(x, y, o, N, chunks);
    else
      flat_kernel<false><<<grid, kFlatThreads, smem, st>>>(x, y, o, N,
                                                           chunks);
  } else if (variant == 1) {
    launch_direct<1>(x, y, o, total, lr, lc, st);
  } else if (C >= 4 && R * (C < kStripCols ? C : kStripCols) <= kStripWords) {
    const int W = C < kStripCols ? C : kStripCols;
    const long long strips = static_cast<long long>(B) * (C / W);
    const int grid = static_cast<int>(strips < kMaxGrid ? strips : kMaxGrid);
    const int smem = R * W * 4;
    const bool vec = aligned16(x) && aligned16(y) && aligned16(o);
    const int e = vec ? raise_smem(row_kernel<true>, 0)
                      : raise_smem(row_kernel<false>, 1);
    if (e) return e;
    if (vec)
      row_kernel<true><<<grid, kThreads, smem, st>>>(x, y, o, R, C, W, strips);
    else
      row_kernel<false><<<grid, kThreads, smem, st>>>(x, y, o, R, C, W,
                                                      strips);
  } else {
    launch_direct<2>(x, y, o, total, lr, lc, st);
  }
  return static_cast<int>(cudaGetLastError());
}

bool pow2_upto(long long v, long long most) {
  return v > 0 && v <= most && !(v & (v - 1));
}

// The Python entry's gathers (pyentry.h): x and idx int32[B, R, C], B >=
// 1, R and C powers of two up to 8192, code 0 lane, 1 flat, 2 row.
bool stream_valid(const long long* shape, int ndim, int code) {
  return ndim == 3 && shape[0] > 0 && shape[0] <= (1 << 30) &&
         pow2_upto(shape[1], 8192) && pow2_upto(shape[2], 8192) &&
         code >= 0 && code <= 2;
}

int stream_launch(const long long* shape, int, const void* a, const void* b,
                  void* out, int code, cudaStream_t st) {
  return launch_stream(static_cast<const int32_t*>(a),
                       static_cast<const int32_t*>(b),
                       static_cast<int32_t*>(out), static_cast<int>(shape[0]),
                       static_cast<int>(shape[1]), static_cast<int>(shape[2]),
                       code, st);
}

// chase on the cluster body where chase_cluster(N) > 0 (p and out
// 16-byte aligned; scratch unused), else on the global-memory body.
// Returns the launch's error: a cluster launch the runtime refuses is
// returned, never replaced by the other body.
int launch_chase(const int32_t* p, int32_t* o, int32_t* sc, long long* stats,
                 int B, int N, int rounds, cudaStream_t st) {
  const int K = chase_cluster(N);
  if (!K) {
    chase_kernel<<<B, kChaseThreads, 0, st>>>(p, o, sc, stats, N, rounds);
    return static_cast<int>(cudaGetLastError());
  }
  if (static_cast<long long>(B) * K > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p) || !aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int e = raise_smem(chase_cluster_kernel, 4);
  if (e) return e;
  ClusterLaunch l(B, K, N, st);
  const cudaError_t launched = cudaLaunchKernelEx(
      &l.cfg, chase_cluster_kernel, p, o, stats, N, rounds);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

LZ4T_GATHER_MODULE(lz4t_probe_gather, stream_valid, stream_launch,
                   "probe_gather gather")

// chase's plan for a block of N words (a power of two): *cluster, the
// cluster size it launches (0: the global-memory body), and *max_active,
// cudaOccupancyMaxActiveClusters of the cluster body at that size and its
// shared memory (0 on the global-memory body). Returns the runtime's error.
extern "C" int lz4t_probe_chase_plan(int N, int* cluster, int* max_active) {
  const int K = chase_cluster(N);
  *cluster = K;
  *max_active = 0;
  if (!K) return 0;
  const int e = raise_smem(chase_cluster_kernel, 4);
  if (e) return e;
  ClusterLaunch l(1, K, N, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_active, chase_cluster_kernel, &l.cfg));
}

// chase (3) and hops (4); lane, flat and row launch through the Python
// entry above. a, b: int32[B, R, C] (chase: p and unused; hops: nm and
// ml); out: int32[B, R, C] (hops: int32[B, steps]); scratch: int32[B, R,
// C] for chase (the global-memory body's; the cluster body leaves it
// unused, and it stays in the contract); stats: int64[B, 2]. R and C are
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
    case 3:
      return launch_chase(x, o, static_cast<int32_t*>(scratch),
                          static_cast<long long*>(stats), B, N, steps, st);
    case 4:
      hops_kernel<<<B, 1, 0, st>>>(x, y, o, static_cast<long long*>(stats),
                                    N, steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
