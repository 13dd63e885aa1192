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
//   time, with the block's bytes and its table in shared memory
//   (solo_smem: 213,024 bytes; 229,408 in dict mode). Without a history
//   the row is staged once, with a zero tail. In dict mode the table has
//   the bit array, and the history and the row share one window
//   (WinSource), since the 136 KB table, the 64 KB history and the 64 KB
//   row do not fit at once; a block whose parse reads past what the
//   window holds is parsed again with its row staged and its history in
//   device memory (row_block). Every link of the lone chain then comes
//   back from shared memory. The first warp parses and hands each sequence
//   over as a record (output position, literal start and length, offset,
//   match length) through a ring in shared memory; the CTA's other three
//   warps, one on each of the SM's other schedulers, write the tokens,
//   length bytes and literals, so the emission leaves the chain.
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
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "mbarrier.cuh"
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
// Dict mode's window: the 64 KB history and kLead block bytes ahead of it
// (16-byte pieces), then a 16-byte tail
constexpr int kLead = 8192;
constexpr int kWin = kDictCap + kLead;
constexpr int kNear = kLead / 2;    // served at least this far past the anchor
constexpr int kStageMin = 512;      // bytes staged a group, but to catch up
// a probe's reads, and its match's up to the first forward step and the
// tail insert, end within kReach bytes of it
constexpr int kReach = 160;

// Cost-split variants (lz4_tpu_torch/probes/b1_split.py), not for use:
// LZ4T_B1_NOLITS copies no literal bytes, LZ4T_B1_NOEMIT writes no output
// byte (op still advances; the solo path hands over the last record
// only), LZ4T_B1_NOSRCH replaces the hash search with a match forced 16
// bytes after the anchor, 16 bytes back, LZ4T_B1_NOPRE makes no history
// pre-insert. LZ4T_B1_SOLO_WAVES=W takes the solo path up to W blocks an
// SM (0: every launch on the device tables). LZ4T_B1_COUNT counts the
// dict solo parse's reads (lz4t_encode_serial_counts).
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
#ifdef LZ4T_B1_NOPRE
constexpr bool kPreinsert = false;
#else
constexpr bool kPreinsert = true;
#endif
#ifdef LZ4T_B1_SOLO_WAVES
constexpr int kSoloWaves = LZ4T_B1_SOLO_WAVES;
#else
constexpr int kSoloWaves = 1;
#endif
#ifdef LZ4T_B1_COUNT
constexpr bool kCount = true;
// per block b < kCountRows, of the last dict solo launch: the parse
// warp's reads of the window's history, of its block bytes, and of the
// row in device memory; the bytes it staged
constexpr int kCountRows = 1024;
__device__ unsigned long long g_counts[kCountRows][4];
#else
constexpr bool kCount = false;
#endif


template <bool kDict>
__host__ __device__ constexpr size_t table_bytes() {
  return kTableSize * 2 + (kDict ? kTableSize / 8 : 0);
}

// A solo CTA's block bytes in shared memory: the row with its zero tail,
// or dict mode's window with its tail.
template <bool kDict>
__host__ __device__ constexpr int solo_bytes() {
  return kDict ? kWin + 16 : kRowBytes;
}

// A solo CTA's dynamic shared memory: the ring, the table, the block's
// bytes and the four counters of the hand-over.
template <bool kDict>
constexpr int solo_smem() {
  return kRing * 16 + static_cast<int>(table_bytes<kDict>()) +
         solo_bytes<kDict>() + 16;
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
  static constexpr bool has_dict = kDict;
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
  // the anchor moves to block byte ax: nothing to stage
  __device__ __forceinline__ void stage(int, int) const {}
  // every probe is served: no pair is cut (WinSource: see there)
  static constexpr bool kCuts = false;
};

// The dict solo path's bytes: the history and the block share one window
// of kWin = 65,536 + kLead bytes in shared memory (and a 16-byte tail),
// logical position q in slot q mod kWin: history byte h in slot h, block
// byte x < kLead in slot 65536 + x, block byte x >= kLead in history slot
// x - kLead. No read of the history falls below index anchor_x + 1 (a
// candidate lies at most max_dist <= 65535 before a probe at or past the
// anchor, and the back count stops there too), so once the anchor has
// passed block byte ax, the history slots below ax are free: stage copies
// block bytes up to ax + kLead into them, in 16-byte cp.async pieces, and
// takes as served what completed groups carried. The tail holds block
// bytes [kLead, kLead + 16), so a word read across the wrap needs no
// branch.
//
// Every read of the parse comes from the window, with no branch: the
// parse is one lone chain, and a fallback in each read (a branch, or
// loads predicated between the window and the row) lengthens it by a
// quarter to a half. Only a probe can run past the served part (kNear to
// kLead past the anchor: in a literal run, which holds the anchor while
// the probes run on, or at an acceleration whose windows span more); a
// forward count stages on as it goes. So a window cuts, as though past
// the block's end, every pair of probes (an even lane and the odd one
// after it, one step of the serial loop) within kReach of the served
// part's end: the lanes before them insert as usual, and the parse stops
// there. The parse warp then stages the row over the window and goes on
// from the first cut probe as the path did before the window, the row in
// shared memory and the history in device memory. The output warps read
// the literals from the row in device memory.
struct WinSource {
  static constexpr bool has_dict = true;
  static constexpr int d0 = kDictCap;
  static constexpr bool kCuts = true;
  uint8_t* win;
  const uint8_t* row;   // the block's row in device memory, cap_n bytes
  int cap_n;
  int last_word;        // index of the row's last whole aligned word
  bool row_words;       // the row may be read as aligned words
  int served;           // block bytes [0, served) are in their slots
  int issued;           // ... and [served, issued) on their way
  int end;              // nothing is staged from here
  int trigger;          // stage has nothing to do while the anchor is below
  int reach;            // a probe pair past this logical position is cut
  // LZ4T_B1_COUNT: reads of the history and of block bytes; bytes staged
  mutable unsigned n_hist, n_block, n_staged;

  __device__ __forceinline__ static int slot(int q) {
    return q < kWin ? q : q - kWin;
  }
  __device__ __forceinline__ uint32_t row_byte(int i) const {
    return i < cap_n ? __ldg(row + i) : 0u;
  }
  // 4 bytes of the row in device memory at row index i >= 0 (literals)
  __device__ __forceinline__ uint32_t row4(int i) const {
    if (!row_words)
      return row_byte(i) | (row_byte(i + 1) << 8) | (row_byte(i + 2) << 16) |
             (row_byte(i + 3) << 24);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (i >> 2);
    return __funnelshift_r(__ldg(w), __ldg(w + ((i >> 2) < last_word)),
                           (i & 3) * 8);
  }
  __device__ __forceinline__ void count(int q) const {
    if (kCount) ++(q < d0 ? n_hist : n_block);
  }
  __device__ __forceinline__ uint32_t byte(int q) const {
    count(q);
    return win[slot(q)];
  }
  __device__ __forceinline__ uint32_t read4(int q) const {
    count(q);
    const int i = slot(q);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(win) + (i >> 2);
    return __funnelshift_r(w[0], w[1], (i & 3) * 8);
  }
  // a probe pair whose odd probe lies at q is cut (scan)
  __device__ __forceinline__ bool cut(int q) const { return q > reach; }
  // the anchor moves to block byte ax, or a forward count has passed it
  // (the parse warp, once every read below ax is done): block bytes
  // [issued, min(end, ax + kLead)) go to history slots below ax as a new
  // group, once there are kStageMin of them. The served frontier is kept
  // at least kNear past the anchor: where it falls short, the warp waits
  // for the groups before the newest, or for all of them after a jump of
  // the anchor past what they carried.
  __device__ __forceinline__ void stage(int ax, int lane) {
    if (__builtin_expect(ax < trigger, 1)) return;
    const int t = min(end, (ax + kLead) & ~15);
    const int need = min(end, ax + kNear);
    const int old = issued;
    if (t > old) {
      for (int x = old + 16 * lane; x < t; x += 32 * 16) {
        lz4t::cp_async16(win + x - kLead, row + x);
        if (kCount) n_staged += 16;
      }
      lz4t::cp_async_commit();
      issued = t;
    }
    if (served < need) {
      if (issued > old && old >= need) {
        lz4t::cp_async_wait<1>();
        served = old;
      } else {
        lz4t::cp_async_wait<0>();
        served = issued;
      }
      __syncwarp();
    }
    retrigger();
  }
  // the least anchor at which stage has something to do (the served
  // frontier falls below kNear past it, or kStageMin bytes can go), and
  // the cut's bound (none once the block is served to its end)
  __device__ __forceinline__ void retrigger() {
    const int a = served >= end ? INT_MAX : served - kNear + 1;
    const int b = issued + kStageMin > end ? INT_MAX
                                           : issued + kStageMin - kLead;
    trigger = min(a, b);
    reach = served >= end ? INT_MAX : d0 + served - kReach;
  }
  // LZ4T_B1_COUNT: block b's figures (the reads and bytes summed over the
  // warp; left: the parse went over to the row)
  __device__ __forceinline__ void store_counts(int b, bool left,
                                               int lane) const {
#ifdef LZ4T_B1_COUNT
    const unsigned c[4] = {n_hist, n_block, 0u, n_staged};
    for (int k = 0; k < 4; ++k) {
      const unsigned v = __reduce_add_sync(kFull, c[k]);
      if (lane == 0 && b < kCountRows) g_counts[b][k] = k == 2 ? left : v;
    }
#endif
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

// The position of the odd probe of lane's pair (lane | 1) in the window
// whose first probe sits at wp with srch j0 (as load_window places it).
__device__ __forceinline__ int pair_end(int wp, int j0, int lane) {
  const int k = lane | 1;
  return wp + k * (j0 >> kSkipTrigger) + max(0, k - (64 - (j0 & 63)));
}

// The window whose first probe sits at wp with srch j0. The gap from
// probe i to probe i + 1 is (srch_i >> 6), srch_i = j0 + i, so lane k's
// probe sits k * (j0 >> 6) further, plus one for each srch that has
// passed the next multiple of 64 (k < 64: at most one).
template <class S>
__device__ __forceinline__ Window load_window(const S& s,
                                              const Table<S::has_dict>& tab,
                                              int wp, int j0, int mflimit,
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
// candidate. Where a source cuts probes (S::kCuts), a scan that ends sets
// cand to -1 at the block's end, or, where it ends at a cut pair, p and
// cand to the first cut probe's position and srch.
template <class S>
__device__ bool scan(const S& s, Table<S::has_dict>& tab,
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
    unsigned hits = __ballot_sync(kFull, hit);
    unsigned act = __ballot_sync(kFull, w.active);
    if constexpr (S::kCuts) {
      // the rare window that reaches the source's cut (w.next lies past
      // every probe): a cut pair reads on, but neither inserts nor takes
      // a match
      if (__builtin_expect(s.cut(w.next), 0)) {
        const int wp = __shfl_sync(kFull, w.q, 0);
        const unsigned keep =
            __ballot_sync(kFull, !s.cut(pair_end(wp, w.j0, lane)));
        hits &= keep;
        act &= keep;
      }
    }
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
    if (act != kFull) {  // an even probe passed mflimit, or a pair was cut
      if constexpr (S::kCuts) {
        const int f = __ffs(~act) - 1;
        const int wp = __shfl_sync(kFull, w.q, 0);
        cand = -1;
        if (s.cut(pair_end(wp, w.j0, f))) {
          p = __shfl_sync(kFull, w.q, f);
          cand = w.j0 + f;
        }
      }
      return false;
    }
    w = load_window(s, tab, w.next, w.j0 + 32, mflimit, matchlimit, lane);
  }
}

// Equal bytes going back from (p, c), at most kmax, from k0 on.
template <class S>
__device__ __forceinline__ int back_count(const S& s, int p, int c, int kmax,
                                          int k0, int lane) {
  for (int k = k0; k < kmax; k += 32) {
    const int i = k + lane;
    const bool stop = i >= kmax || s.byte(p - 1 - i) != s.byte(c - 1 - i);
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) return k + __ffs(m) - 1;
  }
  return kmax;
}

// Equal bytes at q1 + i and q2 + i, i < maxn, from c0 on. The next
// anchor lies at q1 + c or past it once c bytes are equal, and the
// history reads stay above it (q2 >= q1 - 65535), so a window stages on
// from there and a long match never runs past what it holds.
template <class S>
__device__ __forceinline__ int fwd_count(S& s, int q1, int q2, int maxn,
                                         int c0, int lane) {
  for (int c = c0; c < maxn; c += 128) {
    if constexpr (S::kCuts) s.stage(q1 + c - S::d0, lane);
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
template <class S>
__device__ void write_records(const S& s, const int4* ring, int* ctl, int k,
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

// Where a parse goes on from: its anchor, and the first probe (position,
// srch) of its next scan, which has no tail insert pending.
struct Resume {
  int anchor;
  int wp;
  int j0;
};

// Parse one block (the whole warp), its sequences going to `out`: from
// its start, or with r from where r says. Where the source cuts a probe
// pair (WinSource) the parse stops there: r (never null then) holds
// where it goes on from with another source, and it returns false; else
// true, the block done.
template <class S, class Out>
__device__ bool parse_block(S& s, Table<S::has_dict>& tab, int n, int low,
                            Out& out, int accel, int max_dist, int lane,
                            Resume* r = nullptr) {
  constexpr int d0 = S::d0;
  const int mflimit = d0 + n - kMfLimit;          // last match start
  const int matchlimit = d0 + n - kLastLiterals;  // match bytes end here
  const int accel0 = accel << kSkipTrigger;
  int anchor = r ? r->anchor : d0;
  int p = anchor;
  int cand = 0;
  int ext = 0;
  bool hit = scan(s, tab,
                  load_window(s, tab, r ? r->wp : p, r ? r->j0 : accel0,
                              mflimit, matchlimit, lane),
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
    s.stage(next - d0, lane);  // the history below the new anchor is free
    out.sequence(s, anchor - d0, p2 - anchor, offset, ml - kMinMatch, lane);
    anchor = next;
    p = anchor;
    hit = scan(s, tab, w, p, cand, ext, ht, t2, low, mflimit, matchlimit,
               max_dist, lane);
  }
  if constexpr (S::kCuts) {
    if (cand >= 0) {
      *r = Resume{anchor, p, cand};
      return false;
    }
  }
  // the final literal run
  out.last(s, anchor - d0, max(d0 + n - anchor, 0), lane);
  return true;
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
    if (kDict && kPreinsert) {  // history pre-insert, largest position wins
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

// A dict solo CTA's table cleared (all threads).
__device__ __forceinline__ void clear_table(uint8_t* tmem, int tid) {
  uint4* z = reinterpret_cast<uint4*>(tmem);
  for (int i = tid; i < static_cast<int>(table_bytes<true>() / 16);
       i += kSoloThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// A dict solo CTA's start of a block (all threads): the table cleared,
// the ring's counters reset, the history [low, 65536) and block bytes
// [0, kLead + 16) staged to the window (cp.async where 16-byte aligned),
// zeros past a shorter row (as the parse reads past any row), then one
// barrier; returns the block's source (whose staging needs row16: a row
// in 16-byte pieces).
__device__ __forceinline__ WinSource window_block(
    uint8_t* tmem, uint8_t* win, int* ctl, const uint8_t* row,
    const uint8_t* hist, int n, int low, int cap_n, bool row_words,
    bool row16, int tid) {
  const int head = min(cap_n, kLead + 16);
  if ((reinterpret_cast<uintptr_t>(hist) & 15) == 0) {
    for (int i = (low >> 4) + tid; i < kDictCap / 16; i += kSoloThreads)
      lz4t::cp_async16(win + 16 * i, hist + 16 * i);
  } else {
    for (int i = low + tid; i < kDictCap; i += kSoloThreads)
      win[i] = __ldg(hist + i);
  }
  if (row16) {
    for (int i = tid; i < head / 16; i += kSoloThreads)
      lz4t::cp_async16(win + kDictCap + 16 * i, row + 16 * i);
  } else {
    for (int i = tid; i < head; i += kSoloThreads)
      win[kDictCap + i] = __ldg(row + i);
  }
  lz4t::cp_async_commit();
  for (int i = kDictCap + head + tid; i < kWin + 16; i += kSoloThreads)
    win[i] = 0;
  clear_table(tmem, tid);
  if (tid <= kOutWarps) ctl[tid] = max(tid - 1, 0);
  lz4t::cp_async_wait<0>();
  __syncthreads();
  WinSource s{win, row, cap_n, cap_n / 4 - 1, row_words, kLead, kLead,
              min((n + 15) & ~15, cap_n), 0, 0, 0, 0, 0};
  s.retrigger();
  return s;
}

// The history pre-insert of a dict solo CTA (all threads), largest
// position wins; then one barrier.
template <class S>
__device__ __forceinline__ void preinsert(const S& s, Table<true>& tab,
                                          int low, int dict_stride,
                                          int tid) {
  if (!kPreinsert) return;
  const long long step = static_cast<long long>(kSoloThreads) * dict_stride;
  for (long long q = low + static_cast<long long>(tid) * dict_stride;
       q < kDictCap; q += step)
    tab.put_max(hash4(s.read4(static_cast<int>(q))),
                static_cast<uint32_t>(q));
  __syncthreads();
}

// The parse warp's copy of a dict block's row over its window, with a
// zero tail: the rest of the parse reads the row there and the history in
// device memory (the solo path's reads before the window).
__device__ __forceinline__ void row_over_window(uint8_t* win,
                                                const uint8_t* row,
                                                int cap_n, bool row16,
                                                int lane) {
  lz4t::cp_async_wait<0>();  // no staged piece lands after the row
  if (row16) {
    for (int i = lane; i < cap_n / 16; i += 32)
      lz4t::cp_async16(win + 16 * i, row + 16 * i);
    lz4t::cp_async_commit();
  } else {
    for (int i = lane; i < cap_n; i += 32) win[i] = __ldg(row + i);
  }
  for (int i = cap_n + lane; i < ((cap_n + 15) & ~15) + 16; i += 32)
    win[i] = 0;
  lz4t::cp_async_wait<0>();
  __syncwarp();
}

// The solo path: one CTA of kSoloThreads a block (blocks c, c + gridDim.x,
// ...), the block's bytes and its table in shared memory (solo_smem: the
// ring, the table, the row or dict mode's window, the counters). Warp 0
// parses, warps 1.. write.
template <bool kDict>
__global__ void __launch_bounds__(kSoloThreads, 1)
encode_solo_kernel(const uint8_t* __restrict__ src,
                   const int* __restrict__ lens,
                   const uint8_t* __restrict__ dict,
                   const int* __restrict__ dict_lens,
                   uint8_t* __restrict__ out, int* __restrict__ csizes,
                   int* __restrict__ trailing, int B, int cap_n, int out_w,
                   int accel, int dict_stride, int max_dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  uint8_t* tmem = smem + kRing * sizeof(int4);
  uint8_t* rowb = tmem + table_bytes<kDict>();
  int* ctl = reinterpret_cast<int*>(rowb + solo_bytes<kDict>());
  Table<kDict> tab{reinterpret_cast<uint16_t*>(tmem),
                   reinterpret_cast<uint32_t*>(tmem + kTableSize * 2)};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if constexpr (kDict) {
    const bool row_words =
        (cap_n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0;
    const bool dict_words = (reinterpret_cast<uintptr_t>(dict) & 3) == 0;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const int n = min(max(lens[b], 0), cap_n);
      const int low = kDictCap - min(dict_lens[b], kDictCap);
      const uint8_t* row = src + static_cast<size_t>(b) * cap_n;
      const uint8_t* hist = dict + static_cast<size_t>(b) * kDictCap;
      const bool row16 =
          ((reinterpret_cast<uintptr_t>(row) | cap_n) & 15) == 0;
      WinSource s = window_block(tmem, rowb, ctl, row, hist, n, low, cap_n,
                                 row_words, row16, tid);
      preinsert(s, tab, low, dict_stride, tid);
      if (warp == 0) {
        Handoff h{ring, ctl, 0, 0, kRing};
        Resume r{kDictCap, kDictCap, accel << kSkipTrigger};
        s.n_hist = 0;  // the parse's reads alone
        const bool left = !row16 || !parse_block(s, tab, n, low, h, accel,
                                                 max_dist, lane, &r);
        s.store_counts(b, left, lane);
        if (left) {  // the rest from the row, the history in device memory
          row_over_window(rowb, row, cap_n, row16, lane);
          Source<true, true> g{rowb, hist, cap_n, 0, true, dict_words};
          parse_block(g, tab, n, low, h, accel, max_dist, lane, &r);
        }
        lz4t::cp_async_wait<0>();  // nothing lands in the next block's
      } else {
        write_records(s, ring, ctl, warp - 1,
                      Sink{out + static_cast<size_t>(b) * out_w, out_w},
                      csizes + b, trailing + b, lane);
      }
      __syncthreads();
    }
  } else {
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const int n = min(max(lens[b], 0), cap_n);
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
        for (int i = tid; i < cap_n / 16; i += kSoloThreads)
          d[i] = __ldg(g + i);
      } else {
        for (int i = tid; i < cap_n; i += kSoloThreads)
          rowb[i] = __ldg(row + i);
      }
      for (int i = cap_n + tid; i < ((cap_n + 15) & ~15) + 16;
           i += kSoloThreads)
        rowb[i] = 0;
      if (tid <= kOutWarps) ctl[tid] = max(tid - 1, 0);
      __syncthreads();
      const Source<false, true> s{rowb, nullptr, cap_n, 0, true, false};
      if (warp == 0) {
        Handoff h{ring, ctl, 0, 0, kRing};
        parse_block(s, tab, n, 0, h, accel, max_dist, lane);
      } else {
        write_records(s, ring, ctl, warp - 1,
                      Sink{out + static_cast<size_t>(b) * out_w, out_w},
                      csizes + b, trailing + b, lane);
      }
      __syncthreads();
    }
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

// The solo kernel's dynamic shared memory (has_dict: dict mode's) and
// the threads of a solo CTA (solo 1) or a device-table one (solo 0).
extern "C" int lz4t_encode_serial_smem(int has_dict) {
  return has_dict ? solo_smem<true>() : solo_smem<false>();
}
extern "C" int lz4t_encode_serial_threads(int solo) {
  return solo ? kSoloThreads : 32;
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

#ifdef LZ4T_B1_COUNT
// The counting build's figures of its last dict solo launch, rows
// (at most kCountRows) of {history reads, block reads from the window,
// reads of the row in device memory, bytes staged} to out on the host;
// returns the cudaError_t.
extern "C" int lz4t_encode_serial_counts(unsigned long long* out, int rows) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_counts, static_cast<size_t>(min(rows, kCountRows)) *
                         sizeof(g_counts[0])));
}
#endif
