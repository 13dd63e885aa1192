// B2: LZ4 block decoder: a parse warp per block, then the copies.
//
// Replaces: lz4_tpu/block/decode_pallas.py : _decode_kernel (driven by
// _decode_pallas_raw and decode_blocks_pallas). Same token parse, same
// dict/linked history ahead of the output (positions are d0-based in dict
// mode), same `loose` mode and the same sound-subset error contract bit
// for bit: the last literal run must end exactly at the stream end; no
// write past the output window; a match needs its two offset bytes inside
// the stream, a non-zero offset, a source at or after the first valid
// history byte and, unless loose, literals ending >= 8 bytes before the
// stream end and a start >= 12 bytes before the window end; a stream that
// never reaches its last sequence is an error; olen is 0 on error. The
// output row is unspecified where err is 1.
//
// What bounds it on the card: not bytes. The function reads each
// compressed byte once and writes each decoded byte once (tens of
// microseconds for the 48 MB main path at 3.35 TB/s), but the token parse
// of a block is a serial chain: where a token starts depends on every
// length before it. So the parse chain's latency bounds it, and the
// number of chains an SM can run at once.
//
// What the design does about that: one CTA per block, a parse warp and
// four copy warps and no dynamic shared memory, so every block of the
// main path's batch is in flight at once. The parse warp reads its row
// through L1, two word loads a read, a prefetch 512 bytes ahead. Each
// lane holds the records of the sequences that would start at base +
// lane and base + 32 + lane (literal start and length, match length,
// offset, next token), built from the bytes alone; a record that needs
// more than one extension byte says so and is built in full only if the
// walk lands on it. A hop takes the next token off its record by a
// shuffle, and the 64 records are rebuilt in parallel when a hop leaves
// them. Lane k keeps hop k's record; every 32 hops (or at the end) the
// lanes check their sequences at once (output positions by a prefix
// sum, the checks of the serial decoder, the first failing one in stream
// order by a ballot, which decides err and olen) and publish the valid
// ones into a ring of descriptors in shared memory, with one release
// store of head and the output end of the last. The copy warps take
// descriptors in turn (warp c takes c, c+4, ...) and build the output in
// place in global memory. Literal runs are independent once their output
// position is known. A match copies once every byte of its source window
// is final: each copy warp publishes the output position below which all
// of its own sequences are done (while its next descriptor is
// unpublished, the output end of the last one published), and the
// minimum over the warps bounds the final prefix. A match of any offset
// copies lane-parallel: byte i is byte (i mod offset) of the `offset`
// bytes before it when it overlaps itself. (An output tile in shared
// memory, a shared-memory window for the parse, and two launches with the
// tile and pointer jumping all ran slower on the card: PERF.md.)
//
// Index math is 32-bit (the wrapper checks cap_out + 65536 < 2^31 and
// cap_in < 2^30); reads at or past the input row read 0; the checks keep
// every write inside the output row.
//
// Build variants, for probes/decode_split.py only: LZ4T_B2_PARSE_ONLY
// (the copy warps take descriptors and copy nothing),
// LZ4T_B2_CYCLES (clock64 counters written to the head of each output row
// in place of the output) and LZ4T_B2_PROBE (an entry point that dumps
// the descriptors to device memory or replays them from there: the
// copies alone).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDictCap = 65536;
constexpr int kMinMatch = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;  // lengths saturate here (always fail)
constexpr int kCopyWarps = 4;
constexpr int kThreads = 32 * (1 + kCopyWarps);
constexpr int kDynSmem = 0;     // every block of a batch resident
constexpr int kRing = 256;      // descriptors in flight
// A waiting warp polls every 64 ns: longer sleeps delay the progress
// that other warps' matches wait on (PERF.md).
constexpr int kSpinNs = 64;

enum { kDecode = 0, kDump = 1, kReplay = 2 };

// Acquire loads and release stores of shared control words: a release
// store orders the storing thread's earlier writes, and those of the
// lanes that reached a __syncwarp() with it, before any acquire load
// that reads it.
__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int ld_acq(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"(smem(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :: "r"(smem(p)), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acq64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];"
               : "=l"(v) : "r"(smem(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel64(unsigned long long* p,
                                         unsigned long long v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;"
               :: "r"(smem(p)), "l"(v) : "memory");
}

// The parse warp's view of its compressed row: bytes [q, q+4) as a
// little-endian word, 0 at or past cap_in, through L1 (a staged window in
// shared memory ran no faster on the card: PERF.md).
struct Row {
  const uint8_t* in;
  int cap_in;
  bool words;  // the row is 4-byte aligned: two word loads a read

  __device__ __forceinline__ uint32_t rd4(int q) const {
    if (words && q + 8 <= cap_in) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(in) + (q >> 2);
      return __funnelshift_r(__ldg(w), __ldg(w + 1), (q & 3) * 8);
    }
    uint32_t r = 0;
    for (int j = 0; j < 4; ++j)
      if (q + j < cap_in)
        r |= static_cast<uint32_t>(__ldg(in + q + j)) << (8 * j);
    return r;
  }
};

struct ParseResult {
  int olen;
  int err;
  int count;  // descriptors emitted
};

// The record of the sequence that would start at q0: literal start and
// length, match length, offset and next token (INT_MAX for the last).
struct Rec {
  int start, len, mlen, off, next;
};

// kFast: no extension chain past its first byte; a record that needs
// more says so with next = -1, and the walk builds it in full if it
// lands on it.
template <bool kFast>
__device__ __forceinline__ Rec record(const Row& row, int M, int q0) {
  const uint32_t t4 = row.rd4(q0);
  const int matnib = t4 & 15;
  int litlen = (t4 >> 4) & 15;
  int q = q0 + 1;
  if (litlen == 15) {
    uint32_t v = (t4 >> 8) & 255;
    litlen += v;
    q = q0 + 2;
    if (kFast && v == 255) return Rec{0, 0, 0, 0, -1};
    while (v == 255) {
      v = row.rd4(q) & 255;
      ++q;
      litlen = min(litlen + static_cast<int>(v), kBig);
    }
  }
  const int lit_end = q + litlen;
  Rec r{q, litlen, kMinMatch + matnib, 0, INT_MAX};
  if (lit_end < M) {  // not the last sequence
    const uint32_t m4 = row.rd4(lit_end);
    r.off = m4 & 0xffff;
    r.next = lit_end + 2;
    if (matnib == 15) {
      uint32_t v = (m4 >> 16) & 255;
      r.mlen += v;
      ++r.next;
      if (kFast && v == 255) return Rec{0, 0, 0, 0, -1};
      while (v == 255) {
        v = row.rd4(r.next) & 255;
        ++r.next;
        r.mlen = min(r.mlen + static_cast<int>(v), kBig);
      }
    }
  }
  return r;
}

__device__ __forceinline__ int pick(int a, int b, int j) {
  const int x = __shfl_sync(kFull, a, j & 31);
  const int y = __shfl_sync(kFull, b, j & 31);
  return j < 32 ? x : y;
}

// One warp walks one block (see the header). Each lane holds two records,
// for base + lane and base + 32 + lane. A hop takes only the next token
// off its record; lane k keeps hop k's record, and every 32 hops (or at
// the end) the lanes check their sequences at once: output positions by
// a prefix sum, the checks of the serial decoder, the first failing one
// in stream order by a ballot. emit(n, d, off) is then called by every
// lane for the n valid sequences of the batch: lane k < n holds
// d = (literal source, output position of the match, literal length,
// match length or 0 for the last sequence), positions relative to the
// output row, and its offset.
template <class Emit>
__device__ __forceinline__ ParseResult parse_block(
    Row& row, int M, int d0, int low, int ow, int loose, int lane,
    Emit&& emit, long long* cyc) {
  int o = d0;
  int count = 0;
  if (M <= 0) return {0, 1, 0};  // no sequence at all (or M < 0)
  int base = INT_MIN / 2;
  Rec r0{}, r1{};
  Rec h{};          // lane k: hop k's record
  int p = 0;
  for (;;) {
    int k = 0;
    while (k < 32 && p < M) {
      if (p - base >= 64) {  // rebuild the lanes' records
#ifdef LZ4T_B2_CYCLES
        const long long tb = clock64();
#endif
        base = p;
        if (lane == 0 && p + 512 < row.cap_in)  // L1, ahead of the walk
          asm volatile("prefetch.global.L1 [%0];" ::"l"(row.in + p + 512));
        r0 = record<true>(row, M, p + lane);
        r1 = record<true>(row, M, p + 32 + lane);
#ifdef LZ4T_B2_CYCLES
        __syncwarp();
        cyc[1] += clock64() - tb;
        ++cyc[2];
#endif
      }
      const int j = p - base;
      Rec c{pick(r0.start, r1.start, j), pick(r0.len, r1.len, j),
            pick(r0.mlen, r1.mlen, j), pick(r0.off, r1.off, j),
            pick(r0.next, r1.next, j)};
      if (c.next == -1) c = record<false>(row, M, p);  // a long chain
      if (lane == k) h = c;
      p = c.next;
      ++k;
    }
    // check the k sequences of the batch at once
    const bool live = lane < k;
    const int lit_end = h.start + h.len;
    const bool is_last = h.next == INT_MAX;
    int sz = live ? h.len + (is_last ? 0 : h.mlen) : 0;
    sz = min(sz, kBig);
    int pre = sz;  // inclusive prefix sum of the sizes (saturating)
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, pre, d);
      if (lane >= d) pre = min(pre + v, kBig);
    }
    // this sequence's output start (past ow only where it fails anyway)
    const int o_k = static_cast<int>(
        min(static_cast<long long>(o) + pre - sz, ow + 1LL));
    bool serr = (is_last && lit_end != M) || h.len > ow - o_k;
    const int o_mid = serr ? o_k : o_k + h.len;
    if (!is_last)
      serr = serr || h.next > M || h.off == 0 || (!loose && lit_end > M - 8);
    if (!is_last && !serr)
      serr = o_mid - h.off < low || h.mlen > ow - o_mid ||
             (!loose && o_mid > ow - 12);
    const unsigned fails = __ballot_sync(kFull, live && serr);
    const unsigned lasts = __ballot_sync(kFull, live && is_last);
    const int f = fails ? __ffs(fails) - 1 : k;  // first failing sequence
    emit(f, make_int4(h.start, o_mid - d0, h.len, is_last ? 0 : h.mlen),
         h.off);
    count += f;
    if (f < k) return {0, 1, count};
    if (lasts) return {__shfl_sync(kFull, o_k + sz, k - 1) - d0, 0, count};
    if (p >= M) return {0, 1, count};  // never reached its last sequence
    o = __shfl_sync(kFull, o_k + sz, 31);
  }
}

__device__ __forceinline__ int block_low(const int* dict_lens, int has_dict,
                                         int b, int cap_out) {
  // a negative dict_len puts low past the window: every match fails
  if (!has_dict) return 0;
  const long long low = kDictCap - min(static_cast<long long>(dict_lens[b]),
                                       static_cast<long long>(kDictCap));
  return static_cast<int>(min(low, kDictCap + cap_out + 1LL));
}

struct Ctl {
  // descriptors published (low word) and the output end of the last one
  // published (high word), stored together so a reader sees a pair
  unsigned long long head_ob;
  int total;             // descriptors in all; -1 until the parse ends
  int olen;
  int err;
  // per copy warp, one pair: the output position below which every byte
  // the warp owns is final (high word) and the next descriptor it will
  // read (low word)
  unsigned long long pt[kCopyWarps];
#ifdef LZ4T_B2_CYCLES
  unsigned long long cyc[8];
#endif
};

__device__ __forceinline__ unsigned long long pair(int pos, int taken) {
  return static_cast<unsigned long long>(static_cast<unsigned>(pos)) << 32 |
         static_cast<unsigned>(taken);
}

// Copy warp cw: descriptors cw, cw + C, ... in order, the output in place
// in global memory. It releases its pair when it takes a descriptor and
// when it ends one.
__device__ __forceinline__ void copy_ring(Ctl& ctl, const int4* ring,
                                          const int* ring_off, uint8_t* T,
                                          const uint8_t* __restrict__ in,
                                          int cap_in,
                                          const uint8_t* __restrict__ hist,
                                          int cw, int lane) {
  const int C = kCopyWarps;
  int fp = 0;     // bytes below it are final (a lower bound, refreshed on need)
  int mypos = 0;  // this warp's last published pos
#ifdef LZ4T_B2_CYCLES
  const long long t_start = clock64();
  long long t_head = 0, t_fp = 0;
#endif
  for (int i = cw;; i += C) {
    bool end = false;
#ifdef LZ4T_B2_CYCLES
    const long long t0 = clock64();
#endif
    for (;;) {
      // while descriptor i is unpublished its output starts at or after
      // the published output end ob, so the warp owns no unfinished byte
      // below ob
      const unsigned long long hb =
          __shfl_sync(kFull, ld_acq64(&ctl.head_ob), 0);
      const int ob = static_cast<int>(hb >> 32);
      if (static_cast<int>(hb & 0xffffffffu) > i) break;
      if (ob > mypos) {
        mypos = ob;
        if (lane == 0) st_rel64(&ctl.pt[cw], pair(ob, i));
      }
      const int t = __shfl_sync(kFull, ld_acq(&ctl.total), 0);
      if (t >= 0 && i >= t) {
        end = true;
        break;
      }
      __nanosleep(kSpinNs);
    }
#ifdef LZ4T_B2_CYCLES
    t_head += clock64() - t0;
#endif
    if (end) break;
    __syncwarp();  // lane 0's acquire orders every lane's reads below
    const int4 d = ring[i % kRing];  // lit_src, out_mid, litlen, mlen
    const int off = ring_off[i % kRing];
    const int o0 = d.y - d.z;
    mypos = max(mypos, o0);
    __syncwarp();
    if (lane == 0) st_rel64(&ctl.pt[cw], pair(mypos, i + C));
#ifndef LZ4T_B2_PARSE_ONLY
    for (int k = lane; k < d.z; k += 32) {
      const int q = d.x + k;
      T[o0 + k] = q < cap_in ? __ldg(in + q) : 0;
    }
    if (d.w) {
      const int base = d.y - off;
      const int need = min(base + d.w, o0);  // end of other warps' bytes read
      if (need > fp) {
#ifdef LZ4T_B2_CYCLES
        const long long t1 = clock64();
#endif
        for (;;) {
          const int v = lane < C ? static_cast<int>(ld_acq64(&ctl.pt[lane]) >> 32)
                                 : INT_MAX;
          fp = __reduce_min_sync(kFull, v);
          if (fp >= need) break;
          __nanosleep(kSpinNs);
        }
#ifdef LZ4T_B2_CYCLES
        t_fp += clock64() - t1;
#endif
      }
      __syncwarp();
      const bool periodic = off < d.w;
      for (int k = lane; k < d.w; k += 32) {
        const int x = base + (periodic ? k % off : k);
        T[d.y + k] = x >= 0 ? T[x] : __ldg(hist + kDictCap + x);
      }
    }
#endif
    __syncwarp();
    mypos = d.y + d.w;
    if (lane == 0) st_rel64(&ctl.pt[cw], pair(mypos, i + C));
  }
  if (lane == 0) st_rel64(&ctl.pt[cw], pair(INT_MAX, INT_MAX));
#ifdef LZ4T_B2_CYCLES
  if (lane == 0) {
    atomicAdd(&ctl.cyc[3], static_cast<unsigned long long>(t_head));
    atomicAdd(&ctl.cyc[4], static_cast<unsigned long long>(t_fp));
    atomicAdd(&ctl.cyc[5],
              static_cast<unsigned long long>(clock64() - t_start));
  }
#endif
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
decode_serial_kernel(const uint8_t* __restrict__ comp,
                     const int* __restrict__ comp_lens,
                     const uint8_t* __restrict__ dict,
                     const int* __restrict__ dict_lens, uint8_t* out,
                     int* __restrict__ olen, int* __restrict__ err_out,
                     int cap_in, int cap_out, int has_dict, int loose,
                     int4* gdesc, int* gcount, int max_desc) {
  __shared__ int4 ring[kRing];
  __shared__ int ring_off[kRing];
  __shared__ Ctl ctl;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const uint8_t* in = comp + static_cast<size_t>(b) * cap_in;
  const uint8_t* hist =
      has_dict ? dict + static_cast<size_t>(b) * kDictCap : nullptr;
  uint8_t* dst = out + static_cast<size_t>(b) * cap_out;
  if (threadIdx.x == 0) {
    ctl.head_ob = 0;
    ctl.total = -1;
  }
  if (threadIdx.x < kCopyWarps) ctl.pt[threadIdx.x] = pair(0, threadIdx.x);
#ifdef LZ4T_B2_CYCLES
  if (threadIdx.x < 8) ctl.cyc[threadIdx.x] = 0;
#endif
  __syncthreads();
  if (warp == 0) {
#ifdef LZ4T_B2_CYCLES
    const long long t0 = clock64();
#endif
    const int d0 = has_dict ? kDictCap : 0;
    int i = 0, freed = 0, oend = 0;
    // publish a batch of n descriptors (lane k < n holds one) and release
    // head with the output end of the last
    auto emit = [&](int n, int4 d, int off) {
      if (n == 0) return;
      if (i + n > freed + kRing) {  // wait for the slots' last readers
        for (;;) {
          const int v =
              lane < kCopyWarps
                  ? static_cast<int>(ld_acq64(&ctl.pt[lane]) & 0xffffffffu)
                  : INT_MAX;
          freed = __reduce_min_sync(kFull, v);
          if (i + n <= freed + kRing) break;
          __nanosleep(kSpinNs);
        }
        __syncwarp();
      }
      if (lane < n) {
        ring[(i + lane) % kRing] = d;
        ring_off[(i + lane) % kRing] = off;
        if (kMode == kDump && i + lane < max_desc) {
          int4* g = gdesc + 2 * (static_cast<size_t>(b) * max_desc + i + lane);
          g[0] = d;
          g[1] = make_int4(off, 0, 0, 0);
        }
      }
      __syncwarp();
      oend = __shfl_sync(kFull, d.y + d.w, n - 1);
      i += n;
      if (lane == 0)
        st_rel64(&ctl.head_ob, static_cast<unsigned long long>(oend) << 32 |
                                   static_cast<unsigned>(i));
    };
    long long cyc[3] = {0, 0, 0};
    ParseResult r{0, 1, 0};
    if (kMode == kReplay) {  // the descriptors of a dump, 32 a load
      const int n = gcount[b];
      const int4* g = gdesc + 2 * static_cast<size_t>(b) * max_desc;
      for (int k0 = 0; k0 < n; k0 += 32) {
        int4 d = make_int4(0, 0, 0, 0);
        int off = 0;
        if (k0 + lane < n) {
          d = g[2 * (k0 + lane)];
          off = g[2 * (k0 + lane) + 1].x;
        }
        emit(min(32, n - k0), d, off);
      }
      r = ParseResult{oend, 0, n};
    } else {
      Row row{in, cap_in, (reinterpret_cast<uintptr_t>(in) & 3) == 0};
      r = parse_block(row, comp_lens[b], d0,
                      block_low(dict_lens, has_dict, b, cap_out), d0 + cap_out,
                      loose, lane, emit, cyc);
    }
    if (lane == 0) {
      ctl.olen = r.olen;
      ctl.err = r.err;
      if (kMode == kDump) gcount[b] = min(i, max_desc);
      st_rel(&ctl.total, i);
    }
#ifdef LZ4T_B2_CYCLES
    if (lane == 0) {
      ctl.cyc[0] = clock64() - t0;
      ctl.cyc[1] = cyc[1];
      ctl.cyc[2] = cyc[2];
      ctl.cyc[6] = i;
    }
#endif
  } else {
    copy_ring(ctl, ring, ring_off, dst, in, cap_in, hist, warp - 1, lane);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    olen[b] = ctl.olen;
    err_out[b] = ctl.err;
  }
#ifdef LZ4T_B2_CYCLES
  // parse cycles, rebuild cycles, rebuilds, copy warps' waits for
  // descriptors and for source bytes, their cycles, descriptors
  if (threadIdx.x < 7 && cap_out >= 56)
    reinterpret_cast<unsigned long long*>(dst)[threadIdx.x] = ctl.cyc[threadIdx.x];
#endif
}

template <int kMode>
int launch(const void* comp, const void* comp_lens, const void* dict,
           const void* dict_lens, void* out, void* olen, void* err, int B,
           int cap_in, int cap_out, int has_dict, int loose, void* gdesc,
           void* gcount, int max_desc, void* stream) {
  decode_serial_kernel<kMode>
      <<<B, kThreads, kDynSmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(comp),
          static_cast<const int*>(comp_lens),
          static_cast<const uint8_t*>(dict),
          static_cast<const int*>(dict_lens), static_cast<uint8_t*>(out),
          static_cast<int*>(olen), static_cast<int*>(err), cap_in, cap_out,
          has_dict, loose, static_cast<int4*>(gdesc),
          static_cast<int*>(gcount), max_desc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode B blocks; returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_decode_serial(const void* comp, const void* comp_lens,
                                  const void* dict, const void* dict_lens,
                                  void* out, void* olen, void* err, int B,
                                  int cap_in, int cap_out, int has_dict,
                                  int loose, void* stream) {
  return launch<kDecode>(comp, comp_lens, dict, dict_lens, out, olen, err, B,
                         cap_in, cap_out, has_dict, loose, nullptr, nullptr,
                         0, stream);
}

// The CTA's threads and its dynamic shared memory, as the launch uses them.
extern "C" int lz4t_decode_serial_threads() { return kThreads; }
extern "C" int lz4t_decode_serial_smem() { return kDynSmem; }

#ifdef LZ4T_B2_PROBE
// The copies alone: mode 1 decodes and dumps each block's descriptors
// (two int4 each, at most max_desc a block) and their count; mode 2
// replays them into the ring in place of the parse.
extern "C" int lz4t_decode_serial_desc(const void* comp, const void* comp_lens,
                                       void* out, void* olen, void* err, int B,
                                       int cap_in, int cap_out, void* gdesc,
                                       void* gcount, int max_desc, int mode,
                                       void* stream) {
  if (mode == kDump)
    return launch<kDump>(comp, comp_lens, nullptr, nullptr, out, olen, err, B,
                         cap_in, cap_out, 0, 0, gdesc, gcount, max_desc,
                         stream);
  return launch<kReplay>(comp, comp_lens, nullptr, nullptr, out, olen, err, B,
                         cap_in, cap_out, 0, 0, gdesc, gcount, max_desc,
                         stream);
}
#endif
