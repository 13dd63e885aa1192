// B1: greedy LZ4 fast-tier block encoder, one warp parsing each LZ4 block.
//
// Replaces: lz4_tpu/block/encode_pallas.py : _encode_kernel (driven by
// _encode_pallas_raw and encode_blocks_pallas). The same function, byte
// for byte: Knuth hash of 4 bytes into a 2^16-entry table, two scan
// positions per step with the reference skip rule (gap one srch>>6, gap
// two (srch+1)>>6), back-extension down to the anchor and the history
// start, forward count up to matchlimit, tail insert at p+ml-2, history
// pre-insert at dict_stride before the first scan, and the max_dist cap.
//
// What bounds it on the card: not bytes. The function moves each source
// byte in once and each compressed byte out once (tens of microseconds
// for the 48 MB main path at 3.35 TB/s). The greedy parse is a chain of
// dependent steps per block, so latency bounds it: the memory round trips
// of one step (the probes' bytes, their table entries, the candidate's
// bytes) and the instructions between them, times the steps, over the
// number of parses that run at once.
//
// Two launch shapes run the same parse with the same bytes out; the
// launcher's plan (lz4t_encode_serial_plan) picks one from B, the card's
// SM count and whether the solo kernel fits the card:
// - Device tables, for calls of more blocks than the card has SMs (the
//   48 MB main path, the benchmark's device batch): many parses per SM.
//   Each CTA is one warp with its table in device memory (a uint16 per
//   entry, 128 KB; dict mode adds a bit array of the high bits of its
//   17-bit positions, 8 KB), up to kPerSm CTAs per SM, each looping over
//   blocks. The tables are stream-ordered scratch of the launch
//   (cudaMallocAsync, freed after it), one per CTA. The block's bytes and
//   its 64 KB history are read in place through the read-only cache, two
//   aligned words and a funnel shift per 4 bytes. Each parse waits on L2
//   for its table entries; the parses sharing an SM hide each other's
//   waits.
// - Solo, for calls of at most one block per SM (a host call of 64
//   blocks, a single block): one CTA owns an SM and parses one block at a
//   time, with the block's row (staged once, with a zero tail) and its
//   table in shared memory (solo_smem: 213,024 bytes, 221,216 in dict
//   mode with the bit array; the history stays in device memory). Every
//   link of the lone chain then comes back from shared memory. The first
//   warp parses and hands each sequence over as a record (output
//   position, literal start and length, offset, match length) through a
//   ring in shared memory; the CTA's other three warps, one on each of
//   the SM's other schedulers, write the tokens, length bytes and
//   literals, so the emission leaves the chain.
// Either way the table is cleared for every block, so nothing leaks from
// one block to another (unlike the TPU kernel's 6-bit grid-step tag). A
// zeroed entry reads as position 0, which the TPU table also holds for
// its first block.
//
// The parse warp:
// - The scan runs 32 probes a warp step. The probe positions depend only
//   on the scan's start and acceleration, so lane k takes probe k of the
//   window: it hashes its 4 bytes, reads the table, and takes as its
//   candidate the position of the highest lower lane with the same hash
//   (__match_any_sync) where there is one, which is what the serial loop
//   would have read. The first valid candidate (__ballot_sync) ends the
//   scan; the lanes up to it insert, only the highest of each hash group
//   writing, which leaves the table as the serial loop does.
// - Nearly every scan ends in its first window, so the next scan's first
//   window is loaded (its bytes, hashes and table entries, and the
//   lanes of each slot) right after the forward count, and its loads are
//   in flight while the sequence is written out or handed over. Nothing
//   writes the table in between but the tail insert of the match, which
//   joins that window as a probe before lane 0.
// - Each lane with a candidate in range also compares, in the same
//   round trip as the candidate's 4 bytes, the next 4 bytes and the byte
//   before; for the winning lane that settles most matches. Longer ones
//   take a warp step that compares 32 bytes backwards (one per lane) and
//   128 forwards (4 per lane) at once, a ballot finding the first
//   mismatch of each.
// - Literals go out as aligned 32-bit words, lane-strided; length bytes
//   lane-strided. Nothing is written past the output row.
// - The history pre-insert (dict mode) runs on all lanes at once (all
//   warps of a solo CTA): the serial loop leaves each slot holding the
//   largest position inserted into it, so each lane inserts with an
//   atomic max (a 32-bit CAS on the word that holds two entries).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kHashLog = 16;
constexpr int kTableSize = 1 << kHashLog;
constexpr uint32_t kHashMul = 2654435761u;
constexpr int kSkipTrigger = 6;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;
constexpr int kDictCap = 65536;
constexpr int kPerSm = 8;           // parsing warps (CTAs) per SM at most
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoSlot = 0x10000u;  // a key no hash equals

// The solo path: a parse warp and kOutWarps output warps a CTA, a ring of
// kRing records, the row with a zero tail (the parse reads up to 8 bytes
// past a row's cap_n; row4 reads the word after the one it starts in).
constexpr int kOutWarps = 3;
constexpr int kSoloThreads = 32 * (1 + kOutWarps);
constexpr int kRing = 1024;         // a power of 2
constexpr int kRowBytes = kDictCap + 16;
constexpr int kEnd = 1 << 30;       // the head's flag: the last record is out
// records a release of the head (64 blocks on an H100: every record 4.40
// ms, every 4 or 16 records 4.32 ms)
constexpr int kPublish = 16;

// Cost-split variants (lz4_tpu_torch/probes/b1_split.py), not for use:
// LZ4T_B1_NOLITS copies no literal bytes, LZ4T_B1_NOEMIT writes no output
// byte (op still advances; the solo path hands over the last record
// only), LZ4T_B1_NOSRCH replaces the hash search with a match forced 16
// bytes after the anchor, 16 bytes back. LZ4T_B1_SOLO_WAVES=W takes the
// solo path up to W blocks an SM (0: every launch on the device tables).
#ifdef LZ4T_B1_NOLITS
constexpr bool kCopyLits = false;
#else
constexpr bool kCopyLits = true;
#endif
#ifdef LZ4T_B1_NOEMIT
constexpr bool kEmit = false;
#else
constexpr bool kEmit = true;
#endif
#ifdef LZ4T_B1_NOSRCH
constexpr bool kSearch = false;
#else
constexpr bool kSearch = true;
#endif
#ifdef LZ4T_B1_SOLO_WAVES
constexpr int kSoloWaves = LZ4T_B1_SOLO_WAVES;
#else
constexpr int kSoloWaves = 1;
#endif


template <bool kDict>
__host__ __device__ constexpr size_t table_bytes() {
  return kTableSize * 2 + (kDict ? kTableSize / 8 : 0);
}

// A solo CTA's dynamic shared memory: the ring, the table, the row and
// the four counters of the hand-over.
template <bool kDict>
constexpr int solo_smem() {
  return kRing * 16 + static_cast<int>(table_bytes<kDict>()) + kRowBytes +
         16;
}
static_assert(solo_smem<true>() <= 232448, "over a CTA's shared memory");

__device__ __forceinline__ uint32_t hash4(uint32_t seq) {
  return (seq * kHashMul) >> (32 - kHashLog);
}

// The block's bytes in logical coordinates: [d0 history bytes | block].
// Reads of the block stay inside its cap_n-byte row; the parse never
// uses a byte at or past n. kSmem: the row is staged in shared memory
// with a zero tail, so it is read in words whatever cap_n is.
template <bool kDict, bool kSmem = false>
struct Source {
  static constexpr int d0 = kDict ? kDictCap : 0;
  const uint8_t* row;   // the block's row, cap_n bytes
  const uint8_t* dict;  // its right-aligned 64 KB history (dict mode)
  int cap_n;
  int last_word;        // index of the row's last whole aligned word
  bool row_words;       // the row may be read as aligned words
  bool dict_words;      // the history may be read as aligned words

  __device__ __forceinline__ uint32_t row_byte(int i) const {
    return kSmem ? row[i] : __ldg(row + i);
  }
  __device__ __forceinline__ uint32_t byte(int q) const {
    if (kDict && q < d0) return __ldg(dict + q);
    const int i = q - d0;
    if (kSmem) return row[i];
    return i < cap_n ? __ldg(row + i) : 0u;
  }
  __device__ __forceinline__ uint32_t bytes4(int q) const {
    return byte(q) | (byte(q + 1) << 8) | (byte(q + 2) << 16) |
           (byte(q + 3) << 24);
  }
  // 4 bytes at row index i >= 0; no branch on i, so lanes do not diverge
  // (the row's last word stands in for the one past it, whose bytes are
  // never used)
  __device__ __forceinline__ uint32_t row4(int i) const {
    if (!kSmem && !row_words) return bytes4(i + d0);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (i >> 2);
    if (kSmem) return __funnelshift_r(w[0], w[1], (i & 3) * 8);
    return __funnelshift_r(__ldg(w), __ldg(w + ((i >> 2) < last_word)),
                           (i & 3) * 8);
  }
  __device__ __forceinline__ uint32_t read4(int q) const {
    if (!kDict || q >= d0) return row4(q - d0);
    if (q <= d0 - 4 && dict_words) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(dict) + (q >> 2);
      return __funnelshift_r(__ldg(w), __ldg(w + ((q & 3) != 0)),
                             (q & 3) * 8);
    }
    return bytes4(q);
  }
};

// No-dict: uint16 positions. Dict: 17-bit positions, bit 16 in a bit
// array; every position the parse inserts is >= 65536, so its bit is set
// (the only change a bit ever sees, hence atomicOr for lanes sharing a
// word).
template <bool kDict>
struct Table {
  uint16_t* lo;
  uint32_t* hi;

  __device__ __forceinline__ int get(uint32_t h) const {
    int v = lo[h];
    if (kDict) v |= static_cast<int>((hi[h >> 5] >> (h & 31)) & 1u) << 16;
    return v;
  }
  __device__ __forceinline__ void put(uint32_t h, int q) {
    lo[h] = static_cast<uint16_t>(q);
    if (kDict) atomicOr(&hi[h >> 5], 1u << (h & 31));
  }
  // history pre-insert (q < 65536): keep the largest position per slot
  __device__ __forceinline__ void put_max(uint32_t h, uint32_t q) {
    uint32_t* w = reinterpret_cast<uint32_t*>(lo) + (h >> 1);
    const int sh = (h & 1) * 16;
    uint32_t old = *w;
    while (((old >> sh) & 0xFFFFu) < q) {
      const uint32_t got =
          atomicCAS(w, old, (old & ~(0xFFFFu << sh)) | (q << sh));
      if (got == old) break;
      old = got;
    }
  }
};

// One window of 32 probes with its loads issued: lane k holds probe k.
struct Window {
  int q;          // the probe's position (memory ops clamped to matchlimit)
  bool active;    // the serial loop makes this probe
  bool canhit;    // ... and may take a match there
  uint32_t seq;   // its 4 bytes
  uint32_t h;     // their slot; inactive lanes: a key of their own
  int e;          // the table's entry, before this window's inserts
  unsigned grp;   // the lanes of its slot (__match_any_sync)
  int eq;         // the highest lower lane's position there, if any
  int j0;         // srch of the window's first probe
  int next;       // position of the next window's first probe
};

// The window whose first probe sits at wp with srch j0. The gap from
// probe i to probe i + 1 is (srch_i >> 6), srch_i = j0 + i, so lane k's
// probe sits k * (j0 >> 6) further, plus one for each srch that has
// passed the next multiple of 64 (k < 64: at most one).
template <bool kDict, bool kSmem>
__device__ __forceinline__ Window load_window(const Source<kDict, kSmem>& s,
                                              const Table<kDict>& tab, int wp,
                                              int j0, int mflimit,
                                              int matchlimit, int lane) {
  const int qa = j0 >> kSkipTrigger;
  const int ra = j0 & 63;
  Window w;
  const int pos = wp + lane * qa + max(0, lane - (64 - ra));
  w.j0 = j0;
  w.next = wp + 32 * qa + max(0, ra - 32);
  // even lanes: sp (the loop runs while sp <= mflimit); odd lanes: sp1,
  // its memory ops clamped to matchlimit, inserting whenever its sp ran
  w.q = pos;
  w.active = w.canhit = pos <= mflimit;
  if (lane & 1) {
    w.active = pos - ((j0 + lane - 1) >> kSkipTrigger) <= mflimit;
    w.q = min(pos, matchlimit);
  }
  w.seq = 0;
  w.h = kNoSlot + 1 + lane;
  w.e = 0;
  if (w.active) {
    w.seq = s.read4(w.q);
    w.h = hash4(w.seq);
    w.e = tab.get(w.h);
  }
  // lanes of one hash slot, found while the table entries load
  w.grp = __match_any_sync(kFull, w.h);
  const unsigned lower = w.grp & ((1u << lane) - 1u);
  w.eq = __shfl_sync(kFull, w.q, lower ? 31 - __clz(lower) : lane);
  return w;
}

// Scan to the next validated match from the loaded window w; (ht, t2) is
// the previous match's tail insert, still to be made (ht kNoSlot: none),
// and no insert has been made since w was loaded. Every lane returns the
// same result; on a hit p and cand are the match position and its
// candidate.
template <bool kDict, bool kSmem>
__device__ bool scan(const Source<kDict, kSmem>& s, Table<kDict>& tab,
                     Window w, int& p, int& cand, int& ext, uint32_t ht,
                     int t2, int low, int mflimit, int matchlimit,
                     int max_dist, int lane) {
  if (!kSearch) {
    if (lane == 0 && ht != kNoSlot) tab.put(ht, t2);
    __syncwarp();
    const bool hit = p + 16 <= mflimit;
    cand = p;
    p += 16;
    ext = 8;  // the warp's back-extension and forward count run
    return hit;
  }
  const int anchor = p;
  const unsigned below = (1u << lane) - 1u;
  const unsigned upto = (2u << lane) - 1u;
  for (;;) {
    // lanes of one hash slot: the serial loop reads what the last lower
    // one wrote (or the pending tail insert, before them all)
    const unsigned grp = w.grp;
    int e = w.e;
    if (grp & below) e = w.eq;
    else if (w.h == ht) e = t2;
    // a candidate in range also compares, in the same round trip, the 4
    // bytes after the match's first 4 and the byte before it: ext holds
    // how many of the 4 are equal (bits 0-2) and whether the byte before
    // is equal with room to extend back (bit 3)
    bool hit = false;
    int x = 0;
    if (w.canhit && e < w.q && e >= low && w.q - e <= max_dist) {
      const uint32_t m = s.read4(e);
      const uint32_t f = s.read4(w.q + 4) ^ s.read4(e + 4);
      const bool back = min(w.q - anchor, e - low) > 0 &&
                        s.byte(w.q - 1) == s.byte(e - 1);
      x = (f ? (__ffs(f) - 1) >> 3 : 4) | (back << 3);
      hit = m == w.seq;
    }
    const unsigned hits = __ballot_sync(kFull, hit);
    const unsigned act = __ballot_sync(kFull, w.active);
    const unsigned commit =
        hits ? act & ((2u << (__ffs(hits) - 1)) - 1u) : act;
    const bool mine = (commit >> lane) & 1u;
    if (mine && !(grp & commit & ~upto)) tab.put(w.h, w.q);
    // the tail insert, unless a committed probe of its slot overwrote it
    if (!__any_sync(kFull, mine && w.h == ht) && lane == 0 && ht != kNoSlot)
      tab.put(ht, t2);
    ht = kNoSlot;
    __syncwarp();
    if (hits) {
      const int f = __ffs(hits) - 1;
      p = __shfl_sync(kFull, w.q, f);
      cand = __shfl_sync(kFull, e, f);
      ext = __shfl_sync(kFull, x, f);
      return true;
    }
    if (act != kFull) return false;  // an even probe passed mflimit
    w = load_window(s, tab, w.next, w.j0 + 32, mflimit, matchlimit, lane);
  }
}

// Equal bytes going back from (p, c), at most kmax, from k0 on.
template <bool kDict, bool kSmem>
__device__ __forceinline__ int back_count(const Source<kDict, kSmem>& s,
                                          int p, int c, int kmax, int k0,
                                          int lane) {
  for (int k = k0; k < kmax; k += 32) {
    const int i = k + lane;
    const bool stop = i >= kmax || s.byte(p - 1 - i) != s.byte(c - 1 - i);
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) return k + __ffs(m) - 1;
  }
  return kmax;
}

// Equal bytes at q1 + i and q2 + i, i < maxn, from c0 on.
template <bool kDict, bool kSmem>
__device__ __forceinline__ int fwd_count(const Source<kDict, kSmem>& s,
                                         int q1, int q2, int maxn, int c0,
                                         int lane) {
  for (int c = c0; c < maxn; c += 128) {
    const int ci = c + 4 * lane;
    int good = 0;
    if (ci < maxn) {
      const uint32_t x = s.read4(q1 + ci) ^ s.read4(q2 + ci);
      good = min(x ? (__ffs(x) - 1) >> 3 : 4, maxn - ci);
    }
    const unsigned m = __ballot_sync(kFull, good < 4);
    if (m) {
      const int f = __ffs(m) - 1;
      return c + 4 * f + __shfl_sync(kFull, good, f);
    }
  }
  return maxn;
}

// The output row, written by a whole warp; nothing past cap.
struct Sink {
  uint8_t* o;
  int cap;

  __device__ __forceinline__ void put(int op, uint32_t v) const {
    if (kEmit && op < cap) o[op] = static_cast<uint8_t>(v);
  }
  // continuation bytes of a length field holding ln = value - 15
  __device__ __forceinline__ int len(int op, int ln, int lane) const {
    const int k = ln / 255;
    for (int i = lane; i <= k; i += 32)
      put(op + i, i < k ? 255 : ln - 255 * k);
    return k + 1;
  }
  // the block's bytes [a, a + n) (row indices) to op: head bytes up to a
  // 4-byte boundary of the output, then aligned words, then the tail
  template <class S>
  __device__ __forceinline__ void literals(int op, const S& s, int a, int n,
                                           int lane) const {
    if (!kEmit || !kCopyLits) return;
    const int head = min(
        n, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(o + op) & 3)) &
                            3));
    if (lane < head) put(op + lane, s.row_byte(a + lane));
    op += head;
    a += head;
    n -= head;
    const int nw = n >> 2;
    uint32_t* ow = reinterpret_cast<uint32_t*>(o + op);
    for (int w = lane; w < nw; w += 32) {
      const uint32_t v = s.row4(a + 4 * w);
      if (op + 4 * w + 4 <= cap) {
        ow[w] = v;
      } else {
        for (int k = 0; k < 4; ++k) put(op + 4 * w + k, v >> (8 * k));
      }
    }
    const int t = 4 * nw + lane;
    if (lane < (n & 3)) put(op + t, s.row_byte(a + t));
  }
};

// One sequence to op (the final literal run where kLast): its token,
// literal length bytes, literals [a, a + litlen) of the row, offset and
// match length bytes. Returns the output position after it.
template <bool kLast, class S>
__device__ __forceinline__ int emit(const Sink& o, const S& s, int op, int a,
                                    int litlen, int offset, int m4,
                                    int lane) {
  if (lane == 0)
    o.put(op, (min(litlen, 15) << 4) | (kLast ? 0 : min(m4, 15)));
  ++op;
  if (litlen >= 15) op += o.len(op, litlen - 15, lane);
  o.literals(op, s, a, litlen, lane);
  op += litlen;
  if (kLast) return op;
  if (lane == 0) {
    o.put(op, offset & 255);
    o.put(op + 1, offset >> 8);
  }
  op += 2;
  if (m4 >= 15) op += o.len(op, m4 - 15, lane);
  return op;
}

// The device-table path's output: the parse warp writes each sequence
// itself.
struct Direct {
  Sink o;
  int* csize;
  int* trail;
  int op;

  template <class S>
  __device__ __forceinline__ void sequence(const S& s, int a, int litlen,
                                           int offset, int m4, int lane) {
    op = emit<false>(o, s, op, a, litlen, offset, m4, lane);
  }
  template <class S>
  __device__ __forceinline__ void last(const S& s, int a, int litlen,
                                       int lane) {
    op = emit<true>(o, s, op, a, litlen, 0, 0, lane);
    if (lane == 0) {
      *csize = op;
      *trail = litlen;
    }
  }
};

// Shared-memory counters of the hand-over, ordered by acquire and release
// at the CTA's scope.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

// The solo path's output: the parse warp hands each sequence over to the
// output warps as a record {output position, literal start (row index),
// literal length, offset | match length - 4 << 16} in a ring of kRing;
// a record with offset 0 is the final literal run. ctl[0] (head) counts
// the records handed over, with kEnd once the last is; ctl[1 + k] is
// the next record output warp k takes (its records are k, k + kOutWarps,
// ...), so every record below the least of them has been written and
// its slot may be used again.
struct Handoff {
  int4* ring;
  int* ctl;
  int op;     // output position of the next sequence
  int i;      // records handed over
  int room;   // records that fit before the output warps are asked again

  __device__ __forceinline__ void push(int4 r, int end, int lane) {
    while (i >= room) {  // the same on every lane: lane 0 reads for all
      int m = 0;
      if (lane == 0) {
        m = ld_acquire(ctl + 1);
        for (int k = 2; k <= kOutWarps; ++k) m = min(m, ld_acquire(ctl + k));
      }
      room = __shfl_sync(kFull, m, 0) + kRing;
      if (i >= room) __nanosleep(32);
    }
    if (lane == 0) ring[i & (kRing - 1)] = r;
    ++i;
    if ((end || i % kPublish == 0) && lane == 0) st_release(ctl, i | end);
  }
  template <class S>
  __device__ __forceinline__ void sequence(const S&, int a, int litlen,
                                           int offset, int m4, int lane) {
    if (kEmit)
      push(make_int4(op, a, litlen,
                     static_cast<int>(static_cast<uint32_t>(offset) |
                                      static_cast<uint32_t>(m4) << 16)),
           0, lane);
    op += 3 + litlen + (litlen >= 15 ? (litlen - 15) / 255 + 1 : 0) +
          (m4 >= 15 ? (m4 - 15) / 255 + 1 : 0);
  }
  template <class S>
  __device__ __forceinline__ void last(const S&, int a, int litlen,
                                       int lane) {
    push(make_int4(op, a, litlen, 0), kEnd, lane);
  }
};

// Output warp k of a solo CTA: writes records k, k + kOutWarps, ... as the
// parse warp hands them over, until the block's last record is out; the
// one that takes the final literal run sets the block's csize and trail.
template <bool kDict>
__device__ void write_records(const Source<kDict, true>& s,
                              const int4* ring, int* ctl, int k,
                              const Sink& o, int* csize, int* trail,
                              int lane) {
  for (int i = k;; i += kOutWarps) {
    int h = 0;
    if (lane == 0)
      while (((h = ld_acquire(ctl)) & ~kEnd) <= i && !(h & kEnd))
        __nanosleep(64);
    h = __shfl_sync(kFull, h, 0);
    if ((h & ~kEnd) <= i) return;  // the last record went to another warp
    __syncwarp();
    const int4 r = ring[i & (kRing - 1)];
    if (r.w == 0) {
      const int op = emit<true>(o, s, r.x, r.y, r.z, 0, 0, lane);
      if (lane == 0) {
        *csize = op;
        *trail = r.z;
      }
      return;
    }
    const uint32_t om = static_cast<uint32_t>(r.w);
    emit<false>(o, s, r.x, r.y, r.z, static_cast<int>(om & 0xFFFFu),
                static_cast<int>(om >> 16), lane);
    __syncwarp();
    if (lane == 0) st_release(ctl + 1 + k, i + kOutWarps);
  }
}

// Parse one block (the whole warp), its sequences going to `out`.
template <bool kDict, bool kSmem, class Out>
__device__ void parse_block(const Source<kDict, kSmem>& s, Table<kDict>& tab,
                            int n, int low, Out& out, int accel,
                            int max_dist, int lane) {
  constexpr int d0 = Source<kDict>::d0;
  const int mflimit = d0 + n - kMfLimit;          // last match start
  const int matchlimit = d0 + n - kLastLiterals;  // match bytes end here
  const int accel0 = accel << kSkipTrigger;
  int anchor = d0;
  int p = d0;
  int cand = 0;
  int ext = 0;
  bool hit = scan(s, tab,
                  load_window(s, tab, p, accel0, mflimit, matchlimit, lane),
                  p, cand, ext, kNoSlot, 0, low, mflimit, matchlimit,
                  max_dist, lane);
  while (hit) {
    const int q1 = p + kMinMatch;
    const int q2 = cand + kMinMatch;
    const int maxn = matchlimit - q1;
    int kb = 0;
    int fc = min(ext & 7, maxn);
    if (((ext & 7) == 4 && maxn > 4) || (ext & 8)) {
      // back-extension and forward count, their first steps together
      const int kmax = min(p - anchor, cand - low);
      const bool bstop =
          lane >= kmax || s.byte(p - 1 - lane) != s.byte(cand - 1 - lane);
      int good = 0;
      if (4 * lane < maxn) {
        const uint32_t x = s.read4(q1 + 4 * lane) ^ s.read4(q2 + 4 * lane);
        good = min(x ? (__ffs(x) - 1) >> 3 : 4, maxn - 4 * lane);
      }
      const unsigned mb = __ballot_sync(kFull, bstop);
      const unsigned mf = __ballot_sync(kFull, good < 4);
      kb = mb ? __ffs(mb) - 1 : back_count(s, p, cand, kmax, 32, lane);
      const int ff = mf ? __ffs(mf) - 1 : 0;
      const int fg = __shfl_sync(kFull, good, ff);
      fc = mf ? 4 * ff + fg : fwd_count(s, q1, q2, maxn, 128, lane);
    }

    const int p2 = p - kb;
    const int offset = p - cand;
    const int ml = kb + kMinMatch + fc;
    const int next = p2 + ml;
    const int t2 = next - 2;  // tail insert, made by the next scan
    // the next scan's first window loads while this sequence goes out
    const Window w =
        load_window(s, tab, next, accel0, mflimit, matchlimit, lane);
    const uint32_t ht = hash4(s.read4(t2));
    out.sequence(s, anchor - d0, p2 - anchor, offset, ml - kMinMatch, lane);
    anchor = next;
    p = anchor;
    hit = scan(s, tab, w, p, cand, ext, ht, t2, low, mflimit, matchlimit,
               max_dist, lane);
  }
  // the final literal run
  out.last(s, anchor - d0, max(d0 + n - anchor, 0), lane);
}

// One warp per CTA; CTA c owns table c of `tables` and encodes blocks c,
// c + gridDim.x, ...
template <bool kDict>
__global__ void __launch_bounds__(32)
encode_kernel(const uint8_t* __restrict__ src, const int* __restrict__ lens,
              const uint8_t* __restrict__ dict,
              const int* __restrict__ dict_lens, uint8_t* __restrict__ out,
              int* __restrict__ csizes, int* __restrict__ trailing,
              uint8_t* tables, int B, int cap_n, int out_w, int accel,
              int dict_stride, int max_dist) {
  constexpr int d0 = Source<kDict>::d0;
  const int lane = threadIdx.x;
  uint8_t* mine = tables + blockIdx.x * table_bytes<kDict>();
  Table<kDict> tab{reinterpret_cast<uint16_t*>(mine),
                   reinterpret_cast<uint32_t*>(mine + kTableSize * 2)};
  const bool row_words =
      (cap_n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0;
  const bool dict_words = (reinterpret_cast<uintptr_t>(dict) & 3) == 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = min(max(lens[b], 0), cap_n);
    const int low = kDict ? d0 - min(dict_lens[b], d0) : 0;
    const Source<kDict> s{
        src + static_cast<size_t>(b) * cap_n,
        kDict ? dict + static_cast<size_t>(b) * kDictCap : nullptr,
        cap_n, cap_n / 4 - 1, row_words, dict_words};
    uint4* z = reinterpret_cast<uint4*>(mine);
    for (int i = lane; i < static_cast<int>(table_bytes<kDict>() / 16);
         i += 32)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    if (kDict) {  // history pre-insert, largest position wins
      const long long step = 32LL * dict_stride;
      for (long long q = low + static_cast<long long>(lane) * dict_stride;
           q < d0; q += step)
        tab.put_max(hash4(s.read4(static_cast<int>(q))),
                    static_cast<uint32_t>(q));
      __syncwarp();
    }
    Direct o{Sink{out + static_cast<size_t>(b) * out_w, out_w}, csizes + b,
             trailing + b, 0};
    parse_block(s, tab, n, low, o, accel, max_dist, lane);
    __syncwarp();
  }
}

// The solo path: one CTA of kSoloThreads a block (blocks c, c + gridDim.x,
// ...), everything but the history in shared memory (solo_smem: the ring,
// the table, the row, the counters). Warp 0 parses, warps 1.. write.
template <bool kDict>
__global__ void __launch_bounds__(kSoloThreads, 1)
encode_solo_kernel(const uint8_t* __restrict__ src,
                   const int* __restrict__ lens,
                   const uint8_t* __restrict__ dict,
                   const int* __restrict__ dict_lens,
                   uint8_t* __restrict__ out, int* __restrict__ csizes,
                   int* __restrict__ trailing, int B, int cap_n, int out_w,
                   int accel, int dict_stride, int max_dist) {
  constexpr int d0 = Source<kDict>::d0;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  uint8_t* tmem = smem + kRing * sizeof(int4);
  uint8_t* rowb = tmem + table_bytes<kDict>();
  int* ctl = reinterpret_cast<int*>(rowb + kRowBytes);
  Table<kDict> tab{reinterpret_cast<uint16_t*>(tmem),
                   reinterpret_cast<uint32_t*>(tmem + kTableSize * 2)};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool dict_words = (reinterpret_cast<uintptr_t>(dict) & 3) == 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = min(max(lens[b], 0), cap_n);
    const int low = kDict ? d0 - min(dict_lens[b], d0) : 0;
    const uint8_t* row = src + static_cast<size_t>(b) * cap_n;
    uint4* z = reinterpret_cast<uint4*>(tmem);
    for (int i = tid; i < static_cast<int>(table_bytes<kDict>() / 16);
         i += kSoloThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    // the row, then zeros to a 16-byte boundary and 16 bytes past it
    if (((reinterpret_cast<uintptr_t>(row) | cap_n) & 15) == 0) {
      const uint4* g = reinterpret_cast<const uint4*>(row);
      uint4* d = reinterpret_cast<uint4*>(rowb);
#pragma unroll 8
      for (int i = tid; i < cap_n / 16; i += kSoloThreads) d[i] = __ldg(g + i);
    } else {
      for (int i = tid; i < cap_n; i += kSoloThreads) rowb[i] = __ldg(row + i);
    }
    for (int i = cap_n + tid; i < ((cap_n + 15) & ~15) + 16;
         i += kSoloThreads)
      rowb[i] = 0;
    if (tid <= kOutWarps) ctl[tid] = max(tid - 1, 0);
    __syncthreads();
    const Source<kDict, true> s{
        rowb, kDict ? dict + static_cast<size_t>(b) * kDictCap : nullptr,
        cap_n, 0, true, dict_words};
    if (kDict) {  // history pre-insert on every warp, largest position wins
      const long long step = static_cast<long long>(kSoloThreads) *
                             dict_stride;
      for (long long q = low + static_cast<long long>(tid) * dict_stride;
           q < d0; q += step)
        tab.put_max(hash4(s.read4(static_cast<int>(q))),
                    static_cast<uint32_t>(q));
      __syncthreads();
    }
    if (warp == 0) {
      Handoff h{ring, ctl, 0, 0, kRing};
      parse_block(s, tab, n, low, h, accel, max_dist, lane);
    } else {
      write_records(s, ring, ctl, warp - 1,
                    Sink{out + static_cast<size_t>(b) * out_w, out_w},
                    csizes + b, trailing + b, lane);
    }
    __syncthreads();
  }
}

// Whether a launch of B blocks takes the solo path: B at most the card's
// SMs (a second wave of solo blocks loses to the device tables' two
// warps an SM), and the card holds a solo CTA on an SM (its shared memory
// raised once a device).
template <bool kDict>
cudaError_t plan(int dev, int B, bool* solo, int* sms) {
  *solo = false;
  const cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess || B > *sms * kSoloWaves) return e;
  static std::atomic<unsigned long long> raised{0};
  int per_sm = 0;
  if (lz4t::allow_smem(encode_solo_kernel<kDict>, solo_smem<kDict>(),
                       raised) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, encode_solo_kernel<kDict>, kSoloThreads,
          solo_smem<kDict>()) != cudaSuccess) {
    cudaGetLastError();  // a card without the room: the device tables
    return cudaSuccess;
  }
  *solo = per_sm >= 1;
  return cudaSuccess;
}

template <bool kDict>
int launch(const void* src, const void* lens, const void* dict,
           const void* dict_lens, void* out, void* csizes, void* trailing,
           int B, int cap_n, int out_w, int accel, int dict_stride,
           int max_dist, cudaStream_t stream) {
  if (B <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  bool solo = false;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = plan<kDict>(dev, B, &solo, &sms)) != cudaSuccess)
    return static_cast<int>(e);
  const auto* s8 = static_cast<const uint8_t*>(src);
  const auto* ln = static_cast<const int*>(lens);
  const auto* d8 = static_cast<const uint8_t*>(dict);
  const auto* dl = static_cast<const int*>(dict_lens);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* cs = static_cast<int*>(csizes);
  auto* tr = static_cast<int*>(trailing);
  if (solo) {
    encode_solo_kernel<kDict><<<min(B, sms), kSoloThreads,
                                solo_smem<kDict>(), stream>>>(s8, ln, d8, dl, o8, cs, tr, B,
                                          cap_n, out_w, accel, dict_stride,
                                          max_dist);
    return static_cast<int>(cudaGetLastError());
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, encode_kernel<kDict>, 32, 0)) != cudaSuccess)
    return static_cast<int>(e);
  const int grid = max(1, min(B, sms * min(per_sm, kPerSm)));
  // the tables are the launch's scratch, stream-ordered; the default pool
  // keeps the memory for the next launch
  cudaMemPool_t pool;
  uint64_t keep = UINT64_MAX;
  void* tables = nullptr;
  if ((e = cudaDeviceGetDefaultMemPool(&pool, dev)) != cudaSuccess ||
      (e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold,
                                   &keep)) != cudaSuccess ||
      (e = cudaMallocAsync(&tables, grid * table_bytes<kDict>(), stream)) !=
          cudaSuccess)
    return static_cast<int>(e);
  encode_kernel<kDict><<<grid, 32, 0, stream>>>(
      s8, ln, d8, dl, o8, cs, tr, static_cast<uint8_t*>(tables), B, cap_n,
      out_w, accel, dict_stride, max_dist);
  e = cudaGetLastError();
  const cudaError_t f = cudaFreeAsync(tables, stream);
  return static_cast<int>(e != cudaSuccess ? e : f);
}

}  // namespace

// Whether a launch of B blocks (has_dict: in dict mode) on the current
// device takes the solo path (*solo 1, else 0), and the device's SMs
// (*sms); returns the cudaError_t.
extern "C" int lz4t_encode_serial_plan(int B, int has_dict, int* solo,
                                       int* sms) {
  int dev = 0;
  bool s = false;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = has_dict ? plan<true>(dev, B, &s, sms) : plan<false>(dev, B, &s, sms);
  *solo = s;
  return static_cast<int>(e);
}

// Encode B blocks; returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_encode_serial(const void* src, const void* lens,
                                  const void* dict, const void* dict_lens,
                                  void* out, void* csizes, void* trailing,
                                  int B, int cap_n, int out_w, int has_dict,
                                  int accel, int dict_stride, int max_dist,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return has_dict ? launch<true>(src, lens, dict, dict_lens, out, csizes,
                                 trailing, B, cap_n, out_w, accel,
                                 dict_stride, max_dist, st)
                  : launch<false>(src, lens, dict, dict_lens, out, csizes,
                                  trailing, B, cap_n, out_w, accel,
                                  dict_stride, max_dist, st);
}
