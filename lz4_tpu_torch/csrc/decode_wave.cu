// B3: wave-arena decoder, one CTA per wave-split stream, pieces in parallel.
//
// Replaces: lz4_tpu/block/decode_wave.py : _wave_kernel (driven by
// _wave_decode_raw and, with its 64 KB ring, _wave_decode_ring_raw). It
// computes the same function: the decoded bytes of each stream from the
// arena the host C splitter (lz4t_wave_split) lays out. Piece k of a
// stream holds the sequences of output bytes [k*1024, (k+1)*1024) at arena
// byte k*1088. The wave grammar: a token (literal nibble, match nibble);
// one extension byte iff a nibble is 15; the literals; then, iff the match
// nibble is not 0, a 2-byte offset and the RAW copy length (no +4, 1..255).
// No sequence crosses a piece, but a match may reach back into earlier
// pieces or, in linked mode, into the 64 KB history before position 0.
//
// What bounds it on the card: not bytes. The function reads the used part
// of each piece slot once and writes each decoded byte once (chip_smoke.py
// prints that byte bound for the main path). Latency bounds it: each
// piece's parse is a chain of dependent reads, and the matches of a stream
// form chains (a match copies bytes that an earlier match copied), which
// in stream order run one after another.
//
// What the design does about that: no phase waits on another piece.
// Phase A parses every piece at once, because the splitter fixes where
// each piece sits in the arena and in the output: the CTA's warps take
// the pieces in turn, each piece parsed by one warp in lockstep from a
// copy of its 1088-byte slot staged in shared memory with 16-byte loads.
// Phase A writes every literal byte into the stream's output tile and,
// for every output byte, its source: itself for a literal (a terminal),
// the position it copies for a match byte (position i of a match at
// offset d reads base + (i mod d) when it overlaps itself, so a run
// points straight into its period), and itself again, with its value
// written, for a byte that copies from the history row (negative
// positions; round t-1's output in linked mode). Phase B resolves every
// byte to its terminal by pointer jumping: each round replaces every
// source by its source's source, so a chain of n copies resolves in
// ceil(log2 n) rounds; the rounds stop when one changes nothing. Every
// source is a lower position, so the sources form a forest and the rounds
// end. The write-out gathers tile[source] for every byte up to
// out_lens[b], four bytes a thread. (Copying the matches in stream order
// by one warp, in rounds over all pieces until none changes, or each as
// soon as the pieces it reads have published their progress, all ran
// slower on the card; PERF.md has the figures.)
//
// Where it lives: up to 64 pieces, the tile (64 KB) and the sources (16
// bits each, 128 KB) are in dynamic shared memory, one CTA of 32 warps to
// an SM at 64 pieces. Streams of more than 64 pieces build the output in
// place in global memory with 32-bit sources in device scratch that the
// launcher takes from cudaMallocAsync on the stream and frees after the
// launch: the arena's shape picks the instantiation. (At 64 pieces the
// global instantiation ran 65% slower than the tile on the card: PERF.md.)
//
// The splitter validates the stream, so the kernel runs no format checks;
// it still bounds every read to the piece's own arena slot and every
// write to the stream's own output bytes (a byte no sequence writes keeps
// itself as its source), so a garbage arena can never touch memory
// outside its rows (its output is then unspecified).
//
// Build variants, for probes/decode_split.py only: LZ4T_B3_PARSE_ONLY
// (phase A alone), LZ4T_B3_GLOBAL (the global-memory instantiation at
// every width: what the tile saves), and LZ4T_B3_CYCLES (clock64 counters
// of each phase and the round count, written to the head of each output
// row in place of the output).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kWaveOut = 1024;
constexpr int kWaveCap = 1088;
constexpr int kHist = 65536;
#ifdef LZ4T_B3_GLOBAL
constexpr int kTilePieces = 0;  // the output in global memory at every width
#else
constexpr int kTilePieces = 64;
#endif
constexpr int kSlot = kWaveCap + 16;  // a staged piece and a zero tail
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;

// Phase A for piece k: literals and history bytes into T, every written
// byte's source into S.
template <typename Src>
__device__ __forceinline__ void parse_piece(
    int k, const uint8_t* __restrict__ in, uint8_t* T, Src* S,
    const uint8_t* __restrict__ h, uint32_t* slot, int n_out, bool vec,
    int lane, unsigned long long& seqs) {
  // stage the piece's slot, with a zero tail
  __syncwarp();
  const uint8_t* src = in + static_cast<size_t>(k) * kWaveCap;
  uint4* s4 = reinterpret_cast<uint4*>(slot);
  if (vec) {
    for (int v = lane; v < kWaveCap / 16; v += 32)
      s4[v] = __ldg(reinterpret_cast<const uint4*>(src) + v);
  } else {
    uint8_t* s8 = reinterpret_cast<uint8_t*>(slot);
    for (int q = lane; q < kWaveCap; q += 32) s8[q] = __ldg(src + q);
  }
  if (lane == 0) s4[kWaveCap / 16] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  const uint8_t* s8 = reinterpret_cast<const uint8_t*>(slot);
  // bytes [q, q+4) of the slot, 0 at or past its end
  auto rd4 = [&](int q) -> uint32_t {
    if (q >= kWaveCap) return 0;
    return __funnelshift_r(slot[q >> 2], slot[(q >> 2) + 1], (q & 3) * 8);
  };
  int c = 0;
  int o = k * kWaveOut;
  const int o_end = min(o + kWaveOut, n_out);
  while (o < o_end && c < kWaveCap) {
    const uint32_t t4 = rd4(c);
    int lit = (t4 >> 4) & 15;
    const int mn = t4 & 15;
    ++c;
    if (lit == 15) {
      lit += (t4 >> 8) & 255;
      ++c;
    }
    for (int i = lane; i < lit && o + i < o_end; i += 32) {
      T[o + i] = c + i < kWaveCap ? s8[c + i] : 0;
      S[o + i] = static_cast<Src>(o + i);
    }
    c += lit;
    o += lit;
    int mlen = 0;
    if (mn != 0) {  // else a literal-only sequence: no offset bytes
      const uint32_t m4 = rd4(c);
      const int off = m4 & 0xffff;
      c += 2;
      mlen = mn;
      if (mn == 15) {
        mlen += (m4 >> 16) & 255;
        ++c;
      }
      const int take = min(mlen, o_end - o);
      if (off > 0) {
        const int base = o - off;
        const bool periodic = off < mlen;
        for (int i = lane; i < take; i += 32) {
          const int x = base + (periodic ? i % off : i);
          if (x >= 0) {
            S[o + i] = static_cast<Src>(x);
          } else {
            T[o + i] = h != nullptr && x >= -kHist ? __ldg(h + kHist + x) : 0;
            S[o + i] = static_cast<Src>(o + i);
          }
        }
      }
    }
    o += mlen;
    ++seqs;
  }
}

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
decode_wave_kernel(const uint8_t* __restrict__ arenas,
                   const int* __restrict__ out_lens,
                   const uint8_t* __restrict__ hist, uint8_t* out,
                   int* scratch, int np) {
  using Src = typename std::conditional<kTile, uint16_t, int>::type;
  extern __shared__ __align__(16) uint8_t dyn[];  // the tile, then S
  __shared__ __align__(16) uint32_t slots[kWarps][kSlot / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int cap = np * kWaveOut;
  const uint8_t* in = arenas + static_cast<size_t>(b) * np * kWaveCap;
  uint8_t* dst = out + static_cast<size_t>(b) * cap;
  uint8_t* T = kTile ? dyn : dst;
  Src* S = kTile ? reinterpret_cast<Src*>(dyn + cap)
                 : reinterpret_cast<Src*>(scratch + static_cast<size_t>(b) * cap);
  const int n_out = min(max(out_lens[b], 0), cap);
  const int pieces = (n_out + kWaveOut - 1) / kWaveOut;
  const uint8_t* h = hist ? hist + static_cast<size_t>(b) * kHist : nullptr;
#ifdef LZ4T_B3_CYCLES
  __shared__ unsigned long long cyc[4];
  if (threadIdx.x < 4) cyc[threadIdx.x] = 0;
  const long long t0 = clock64();
#endif
  // a byte that no sequence writes (only in a garbage arena) is its own
  // source
  for (int j = threadIdx.x; j < n_out; j += kThreads) S[j] = static_cast<Src>(j);
  __syncthreads();
  unsigned long long seqs = 0;
  for (int k = warp; k < pieces; k += kWarps)
    parse_piece<Src>(k, in, T, S, h, slots[warp], n_out,
                     (reinterpret_cast<uintptr_t>(in) & 15) == 0, lane, seqs);
  __syncthreads();
#ifdef LZ4T_B3_CYCLES
  const long long t1 = clock64();
#endif
  unsigned rounds = 0;
#ifndef LZ4T_B3_PARSE_ONLY
  // phase B: pointer jumping to each byte's terminal
  for (bool again = true; again; ++rounds) {
    bool changed = false;
    for (int j = threadIdx.x; j < n_out; j += kThreads) {
      const int s = S[j];
      const int t = S[s];
      if (t != s) {
        S[j] = static_cast<Src>(t);
        changed = true;
      }
    }
    again = __syncthreads_or(changed);
  }
#endif
#ifdef LZ4T_B3_CYCLES
  if (lane == 0) atomicAdd(&cyc[2], seqs);
  if (threadIdx.x == 0) {
    cyc[0] = t1 - t0;
    cyc[1] = clock64() - t1;
    cyc[3] = rounds;
  }
  __syncthreads();
  if (threadIdx.x < 4 && cap >= 32)
    reinterpret_cast<unsigned long long*>(dst)[threadIdx.x] = cyc[threadIdx.x];
#else
  (void)rounds;
  // write-out: every byte from its terminal, four bytes a thread
  const bool words = (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
  for (int j = 4 * threadIdx.x; j < n_out; j += 4 * kThreads) {
    if (words && j + 4 <= n_out) {
      const uint32_t v = T[S[j]] | T[S[j + 1]] << 8 | T[S[j + 2]] << 16 |
                         static_cast<uint32_t>(T[S[j + 3]]) << 24;
      if (kTile) {
        *reinterpret_cast<uint32_t*>(dst + j) = v;
      } else {
        // in place: a terminal is never rewritten, so only sources move
        for (int q = 0; q < 4; ++q)
          if (S[j + q] != j + q) dst[j + q] = (v >> (8 * q)) & 255;
      }
    } else {
      for (int q = j; q < min(j + 4, n_out); ++q)
        if (kTile || S[q] != q) dst[q] = T[S[q]];
    }
  }
#endif
}

size_t dyn_bytes(int np) {
  return np <= kTilePieces ? static_cast<size_t>(np) * kWaveOut * 3 : 0;
}

}  // namespace

// Decode B wave-split streams of np pieces each; hist is null or a
// uint8[B, 65536] history row per stream (right-aligned, position -1 at
// its last byte). The arena's shape picks the instantiation: the tile and
// the sources in shared memory up to 64 pieces, the output in global
// memory and the sources in device scratch beyond. Returns the launch's
// cudaError_t (0 on success).
extern "C" int lz4t_decode_wave(const void* arenas, const void* out_lens,
                                const void* hist, void* out, int B, int np,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint8_t*>(arenas);
  const auto* n = static_cast<const int*>(out_lens);
  const auto* hs = static_cast<const uint8_t*>(hist);
  auto* o = static_cast<uint8_t*>(out);
  if (np <= kTilePieces) {
    const size_t smem = dyn_bytes(np);
    cudaFuncSetAttribute(decode_wave_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaFuncSetAttribute(decode_wave_kernel<true>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    decode_wave_kernel<true><<<B, kThreads, smem, st>>>(a, n, hs, o, nullptr,
                                                         np);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0;
  cudaMemPool_t pool;
  uint64_t keep = UINT64_MAX;
  int* scratch = nullptr;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetDefaultMemPool(&pool, dev)) != cudaSuccess ||
      (e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold,
                                   &keep)) != cudaSuccess ||
      (e = cudaMallocAsync(
           reinterpret_cast<void**>(&scratch),
           static_cast<size_t>(B) * np * kWaveOut * sizeof(int), st)) !=
          cudaSuccess)
    return static_cast<int>(e);
  decode_wave_kernel<false><<<B, kThreads, 0, st>>>(a, n, hs, o, scratch, np);
  e = cudaGetLastError();
  cudaFreeAsync(scratch, st);
  return static_cast<int>(e);
}

// Dynamic shared memory of a CTA for np pieces, and the CTA's threads.
extern "C" int lz4t_decode_wave_smem(int np) {
  return static_cast<int>(dyn_bytes(np));
}
extern "C" int lz4t_decode_wave_threads(int np) {
  (void)np;
  return kThreads;
}
