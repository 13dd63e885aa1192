// B4: lockstep-tier match finder, one warp per block, 32 positions a step.
//
// Replaces: lz4_tpu/block/encode_wave.py : _encode_wave_kernel (driven by
// _encode_wave_raw and, in linked mode, _encode_wave_linked_raw). It
// computes the same decision array, identical to the last bit, because the
// host C emitter (lz4t_wave_emit_decisions) turns it into LZ4 bytes: one
// int32 per 4 input bytes, off | sub << 16 | (mlen - 4) << 18 for a match
// of mlen bytes that ends at position 4 * row + sub, else 0.
//
// At each position q, in this order (encode_wave.py:189-266):
//   1. probe the packed entry of hash(x[q:q+4]): two 16-bit positions, the
//      most recent low; take the recent one if it is in range, else the
//      older one;
//   2. insert q when q + 4 <= len, in scanning and matching state alike,
//      shifting the old low half up;
//   3. start a match only while scanning and only if q <= len - 12;
//   4. verify x[cand + q - a] against x[q] at the same q;
//   5. end on a mismatch, at q >= len - 5, or at mlen >= 16384 + 3, and
//      commit only when mlen >= 4.
// The hash is a wrapping 32-bit multiply by 2654435761 and a logical
// shift. In linked mode the table works in mod-2^16 positions: a warmup
// seeds it from the history tail (positions -4*wr + 4*hr + sub for
// hr < wr - 1 and p >= -hlen), distances are taken mod 2^16 with
// d <= q + hlen, and the init sentinel 0xFFFF never matches.
//
// What bounds it on the card: not bytes. The function reads each input
// byte once and writes one decision word per 4 input bytes (about
// 0.03 ms for the 768 x 64 KB main path at 3.35 TB/s); each block's scan
// is a chain of dependent steps, so latency bounds it.
//
// What the design does about that. Step 2 does not depend on the match
// state, so the probe of every position is a pure function of the bytes:
// a warp takes 32 positions a step. Each lane builds its 4-gram from two
// word reads and hashes it; __match_any_sync over the inserting lanes
// (a prefix of the step) gives each lane its nearest and second-nearest
// lower peer of equal hash, which stand for the entry it would have read
// in serial order (the nearest low, the second, else the table's old low
// half, high); the highest inserting lane of each group writes the new
// entry back. The linked warmup is the same operation over the history
// tail. Only steps 3-5 are sequential. Each startable lane first
// measures its agreement: the bytes a start there would verify before
// its first mismatch, up to the step's end (8 words of its candidate
// against 8 words of the step, shuffled from the lanes). Then the
// machine needs no byte read inside a step: the first startable lane at
// or after the cursor starts a match, which ends at its agreement (or at
// len - 5), commits if mlen >= 4, and the lane after the end is the new
// cursor; a match that reaches the step's end carries into the next
// step, where all lanes compare their byte with the candidate's at once
// and the first failing lane ends it. One warp per CTA with the table
// (4 << hash_bits bytes) in shared memory, so all blocks of a batch are
// resident at once; the row is read through L1, the next step's words
// loaded ahead.
// Decisions go into a zeroed array, written only where a match ends.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kKnuth = 2654435761u;
constexpr int kMaxMlen = 16384;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 32;  // one warp per CTA

// One block's input row; bytes at or past len read 0.
struct Row {
  const uint8_t* g;  // in device memory
  int n_rows, len;
  // 4 little-endian bytes at 4 * i
  __device__ __forceinline__ uint32_t word(int i) const {
    if (i >= n_rows || 4 * i >= len) return 0u;
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(g) + i);
    const int keep = len - 4 * i;
    return keep >= 4 ? w : w & ((1u << (8 * keep)) - 1u);
  }
  // byte q, for 0 <= q < min(len, 4 * n_rows)
  __device__ __forceinline__ uint32_t byte(int q) const {
    return __ldg(g + q);
  }
};

// Probe and insert 32 positions at once; lane k's position is pos0 + k.
// Returns the packed entry this lane sees (the serial order's).
__device__ __forceinline__ uint32_t insert_step(uint32_t* table, uint32_t h,
                                                int pos0, bool ins,
                                                int lane) {
  const unsigned grp = __match_any_sync(kFull, h);
  const unsigned peers = grp & __ballot_sync(kFull, ins);
  const uint32_t old = table[h];
  const unsigned below = peers & ((1u << lane) - 1u);
  uint32_t ent = old;
  if (below) {
    const int p1 = 31 - __clz(below);
    const unsigned rest = below ^ (1u << p1);
    const uint32_t c1 = static_cast<uint32_t>(pos0 + p1) & 0xFFFFu;
    const uint32_t c2 =
        rest ? static_cast<uint32_t>(pos0 + 31 - __clz(rest)) & 0xFFFFu
             : old & 0xFFFFu;
    ent = c1 | (c2 << 16);
  }
  __syncwarp();
  if (ins && !(peers >> lane >> 1))
    table[h] = (ent << 16) | (static_cast<uint32_t>(pos0 + lane) & 0xFFFFu);
  __syncwarp();
  return ent;
}

// Byte src of the block (0 <= src < min(len, 4 * n_rows)) or, below 0,
// of its history tail (0 past its start), as the serial scan reads it.
__device__ __forceinline__ uint32_t rd(const Row& x, const uint8_t* hrow,
                                       int wr, int src) {
  if (src >= 0) return x.byte(src);
  return hrow != nullptr && src + 4 * wr >= 0 ? hrow[src + 4 * wr] : 0u;
}

// The same for any src: bytes at or past len, or past the row, read 0.
__device__ __forceinline__ uint32_t rd_any(const Row& x, const uint8_t* hrow,
                                           int wr, int src) {
  if (src >= 0) return (x.word(src >> 2) >> (8 * (src & 3))) & 255u;
  return rd(x, hrow, wr, src);
}

size_t smem_bytes(int hash_bits) { return size_t{4} << hash_bits; }

__global__ void __launch_bounds__(kThreads)
    encode_wave_kernel(const uint8_t* __restrict__ inp,
                       const int* __restrict__ lens,
                       const uint8_t* __restrict__ hist,
                       const int* __restrict__ hlens, int* __restrict__ dec,
                       int n_rows, int wr, int max_dist, int hash_bits) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int hash_rows = 1 << hash_bits;
  const int shift = 32 - hash_bits;
  uint32_t* table = smem;
  for (int r = lane; r < hash_rows; r += 32) table[r] = 0xFFFFFFFFu;

  const int row_bytes = n_rows * 4;
  const int len = lens[b];
  const Row x{inp + static_cast<size_t>(b) * row_bytes, n_rows, len};
  __syncwarp();
  const bool linked = hist != nullptr;
  const uint8_t* hrow =
      linked ? hist + static_cast<size_t>(b) * wr * 4 : nullptr;
  const int hl = linked ? hlens[b] : 0;
  int* drow = dec + static_cast<size_t>(b) * n_rows;

  if (linked) {
    // warmup: seed the table from the history tail; its last row is
    // skipped (that 4-gram spans into the block)
    const int m = 4 * (wr - 1);
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      uint32_t h = 0;
      if (j < m) {
        const uint32_t h4 = hrow[j] | (hrow[j + 1] << 8) |
                            (hrow[j + 2] << 16) |
                            (static_cast<uint32_t>(hrow[j + 3]) << 24);
        h = (h4 * kKnuth) >> shift;
      }
      insert_step(table, h, -4 * wr + j0, j < m && -4 * wr + j >= -hl,
                  lane);
    }
  }

  // no match ends at or past len - 5, so the scan stops at len
  const int q_end = min(len, row_bytes);
  int mode = 0, cand = 0, a = 0;
#ifdef LZ4T_B4_PROBE_ONLY
  int seen = 0;
#endif
#ifdef LZ4T_B4_CYCLES
  // SM cycles of the probe and insert, the start pre-check and the match
  // machine, and the machine's rounds (the probe's counting build)
  long long cy_insert = 0, cy_check = 0, cy_machine = 0;
  int rounds = 0;
#endif
  const int sh = 8 * (lane & 3);
  uint32_t lo = x.word(lane >> 2), hi = x.word((lane >> 2) + 1);
  for (int base = 0; base < q_end; base += 32) {
    const int q = base + lane;
    const int wi = (base >> 2) + (lane >> 2);
    const uint32_t nlo = x.word(wi + 8), nhi = x.word(wi + 9);
    const uint32_t cur4 = __funnelshift_r(lo, hi, sh);
    const bool active = q < q_end;
#ifdef LZ4T_B4_CYCLES
    const long long t0 = clock64();
#endif
    // 1-2. probe and insert, 32 positions at once
    const uint32_t h = (cur4 * kKnuth) >> shift;
    const uint32_t ent = insert_step(table, h, base, active && q + 4 <= len,
                                     lane);
    const int c1 = static_cast<int>(ent & 0xFFFFu);
    const int c2 = static_cast<int>(ent >> 16);
#ifdef LZ4T_B4_CYCLES
    const long long t1 = clock64();
    cy_insert += t1 - t0;
#endif
    bool ok1, ok2;
    int cnd;
    if (linked) {
      const int d1 = (q - c1) & 0xFFFF;
      const int d2 = (q - c2) & 0xFFFF;
      ok1 = d1 >= 1 && d1 <= max_dist && d1 <= q + hl && c1 != 0xFFFF;
      ok2 = d2 >= 1 && d2 <= max_dist && d2 <= q + hl && c2 != 0xFFFF;
      cnd = q - (ok1 ? d1 : d2);
    } else {
      ok1 = q - c1 >= 1 && q - c1 <= max_dist;
      ok2 = q - c2 >= 1 && q - c2 <= max_dist;
      cnd = ok1 ? c1 : c2;
    }
    const bool can_start = active && (ok1 || ok2) && q <= len - 12;
    // the agreement: the bytes a start here would verify before its
    // first mismatch, to the step's end. The step's own 32 bytes from q,
    // as 8 words, come from the lanes' words by shuffles; the
    // candidate's from its row words (history bytes one by one)
    const uint32_t w8 = __shfl_sync(kFull, hi, 28);
    uint32_t raw[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int i = (lane >> 2) + k;
      const uint32_t v = __shfl_sync(kFull, lo, (4 * i) & 31);
      raw[k] = i < 8 ? v : i == 8 ? w8 : 0u;
    }
    int agree = 0;
    if (can_start) {
      uint32_t cw[9];
      if (cnd >= 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) cw[k] = x.word((cnd >> 2) + k);
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int p = (cnd & ~3) + 4 * k;
          cw[k] = rd_any(x, hrow, wr, p) |
                  (rd_any(x, hrow, wr, p + 1) << 8) |
                  (rd_any(x, hrow, wr, p + 2) << 16) |
                  (rd_any(x, hrow, wr, p + 3) << 24);
        }
      }
      const int csh = 8 * (cnd & 3);
      int m = 32;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const uint32_t d = __funnelshift_r(cw[k], cw[k + 1], csh) ^
                           __funnelshift_r(raw[k], raw[k + 1], sh);
        if (d) m = 4 * k + ((__ffs(d) - 1) >> 3);
      }
      agree = min(m, 32 - lane);
    }
    const unsigned startable = __ballot_sync(kFull, can_start && agree > 0);
#ifdef LZ4T_B4_CYCLES
    const long long t2 = clock64();
    cy_check += t2 - t1;
#endif
#ifdef LZ4T_B4_PROBE_ONLY
    seen += __popc(startable);
#else
    // 3-5. the match machine over the step, lane cursor `from`: a match
    // must end at `lim` (q >= len - 5); lanes from `stop` on are past
    // the scan
    const unsigned live = __ballot_sync(kFull, active);
    const unsigned ends = __ballot_sync(kFull, q >= len - 5);
    const int lim = ends ? __ffs(ends) - 1 : 32;
    const int stop = min(32, q_end - base);
    int from = 0;
    bool carried = false;
    if (mode == 1) {  // a match carried from the last step
#ifdef LZ4T_B4_CYCLES
      ++rounds;
#endif
      const uint32_t mb = active ? rd(x, hrow, wr, cand + (q - a)) : 0u;
      const bool good = mb == (cur4 & 255u) && q < len - 5 &&
                        q - a < kMaxMlen + 3;
      const unsigned fail = __ballot_sync(kFull, !good) & live;
      if (!fail) {
        carried = true;  // it runs into the next step
      } else {
        const int f = __ffs(fail) - 1;
        const int mlen = base + f - a;
        if (lane == f && mlen >= 4)
          drow[q >> 2] = (a - cand) | ((f & 3) << 16) |
                         static_cast<int>(static_cast<uint32_t>(mlen - 4)
                                          << 18);
        mode = 0;
        from = f + 1;
      }
    }
    while (!carried) {
#ifdef LZ4T_B4_CYCLES
      ++rounds;
#endif
      const unsigned sm = from < 32 ? startable & (kFull << from) : 0u;
      if (!sm) break;
      const int sl = __ffs(sm) - 1;
      const int e = min(sl + __shfl_sync(kFull, agree, sl), lim);
      const int c = __shfl_sync(kFull, cnd, sl);
      if (e >= stop) {  // it runs past the step
        cand = c;
        a = base + sl;
        mode = 1;
        break;
      }
      if (lane == e && e - sl >= 4)
        drow[q >> 2] = (base + sl - c) | ((e & 3) << 16) |
                       static_cast<int>(static_cast<uint32_t>(e - sl - 4)
                                        << 18);
      from = e + 1;
    }
#ifdef LZ4T_B4_CYCLES
    cy_machine += clock64() - t2;
#endif
#endif
    lo = nlo;
    hi = nhi;
  }
#ifdef LZ4T_B4_PROBE_ONLY
  if (lane == 0) drow[0] = seen;  // keeps the probes; not a decision
#endif
#ifdef LZ4T_B4_CYCLES
  if (lane == 0 && n_rows >= 4) {  // counters in place of decisions
    drow[0] = static_cast<int>(cy_insert >> 4);
    drow[1] = static_cast<int>(cy_check >> 4);
    drow[2] = static_cast<int>(cy_machine >> 4);
    drow[3] = rounds;
  }
#endif
}

}  // namespace

// Dynamic shared memory of one CTA (one block): 2^hash_bits table entries.
extern "C" int lz4t_encode_wave_smem(int hash_bits) {
  return static_cast<int>(smem_bytes(hash_bits));
}

// Threads of one CTA, as the launcher below uses them.
extern "C" int lz4t_encode_wave_threads() { return kThreads; }

// Find matches in B blocks (input rows of n_rows * 4 bytes, 4-byte
// aligned); hist is null or uint8[B, wr * 4] right-aligned history tails
// with hlens int32[B]. dec must be zeroed int32[B, n_rows]. Returns the
// launch's cudaError_t (0 on success).
extern "C" int lz4t_encode_wave(const void* inp, const void* lens,
                                const void* hist, const void* hlens,
                                void* dec, int B, int n_rows, int wr,
                                int max_dist, int hash_bits, void* stream) {
  const size_t smem = smem_bytes(hash_bits);
  cudaError_t e = cudaFuncSetAttribute(
      encode_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_wave_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(inp), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(hist), static_cast<const int*>(hlens),
      static_cast<int*>(dec), n_rows, wr, max_dist, hash_bits);
  return static_cast<int>(cudaGetLastError());
}
