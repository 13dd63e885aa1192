// B5: LZ4 HC block encoder, levels 3-9: each LZ4 block parsed by all the
// warps of one CTA of 32 warps (an SM), or of a cluster of two such CTAs
// where the call's blocks fit on the card two SMs each.
//
// Replaces: lz4_tpu/block/encode_hc_pallas.py : _hc_kernel (driven by
// _encode_hc_raw and encode_blocks_hc_pallas). The same function, not the
// TPU layout: hash chains over a 2^15-entry head table (Knuth hash of 4
// bytes) with 16-bit previous-occurrence deltas; the wider-match search
// (can-beat filter on two bytes at the current best's width, addresses
// clamped at 0; forward count to matchlimit; back-extension toward the
// search's low position); the Search2/Search3 overlap arbitration, a
// machine over states 0 (scan), 1 (Search2) and 2 (Search3); the
// repeat-pattern analysis at depth > 128 (level 9); favor_dec_speed,
// which drops candidates closer than 8. Its streams equal the JAX
// kernel's, the plain version's and the port's C compress_lazy byte for
// byte.
//
// What bounds it on the card: not bytes (each source byte is read once
// and each compressed byte written once: tens of microseconds at 3.35
// TB/s for the 48 MB HC path). On that path's batch the parse makes 0.25
// searches per source byte and visits 0.40 (level 3) and 2.42 (level 9)
// candidates per byte, 0.19 and 0.67 of them scored in full
// (probes/b5_split.py's counting build, PERF.md). Each hop of a chain
// walk needs the last hop's delta, so one parse is a chain of dependent
// instructions: about 60 a hop, some 330 SM cycles, where a shared-memory
// round trip takes about 60. One warp per block (one CTA per SM, for the
// 192 KB of tables) left the SM idle between them: 263 ms at level 9.
// The bound is the latency of that chain over the parses that run at once
// (32 per SM here: about 160,000 candidates per 64 KB block at level 9,
// some 490 cycles a hop in the counting build).
//
// What the design does about that:
// - The delta table is a pure function of the block's bytes. The serial
//   parse inserts every position in order, once, before any later search,
//   and search positions never decrease; so when a search runs at pos,
//   the head of pos's hash is the last q < pos with that hash, and each
//   inserted q holds q - prev(q) (0 where there is none). A pre-pass
//   writes chain[q] = q - prev(q) for every position a search can reach
//   (q <= n - 12), and the parse does no inserts: its head lookup is
//   pos - chain[pos]. The CTA computes it a window of 1024 positions at a
//   time, each warp owning the slots of one hash class (see prepass_cta).
// - The block and its deltas live in shared memory: 128 KB of deltas, the
//   row (cap_n bytes, zero past it, so reads past the row read 0), the
//   head table in the row's space during the pre-pass. Every hop and
//   every candidate read is a shared-memory access, 4 bytes as two
//   aligned words and a funnel shift.
// - 32 parses of a block at once, 64 on two SMs. The machine's sequences
//   after a state-0 turn depend on that turn's position alone. So the
//   searchable positions are cut into 128 parts a CTA, which the warps
//   take in turn (that evens out their time). A part is parsed
//   speculatively from state 0 at its first position up to its first
//   state-0 turn at or past the next part, marking each position it
//   searched from in state 0 and listing its sequences (device scratch of
//   the launch). Then the join after each part is repaired: the true
//   machine runs from where the part's parse stopped up to the first
//   position another part marked, whose parse the true one then follows.
//   The stream is part 0's list, then each repair's and the suffix of the
//   parse it joined, in turn; a repair whose list fills sends the block to
//   one serial parse. Nearly every join closes at once.
// - The width, from the call and the card, with no knob: the launcher
//   asks once a device how many 2-CTA clusters of this kernel the card
//   holds at once (cudaOccupancyMaxActiveClusters; 66 on an H100 SXM). A
//   call of B blocks up to that many runs at width 2: 2B CTAs in clusters
//   of two, a block a cluster, 256 parts a block. Larger calls run at
//   width 1: min(B, SMs) CTAs, each looping over blocks. The kernel reads
//   its width from its cluster; the parse is the same at both.
// - A pair's phases. Each CTA runs the pre-pass and the row copy into its
//   own shared memory, so no chain hop or candidate read leaves the SM
//   (distributed shared memory is slow for scattered reads). A cluster
//   barrier; the 64 warps take the speculative parts from one counter in
//   rank 0's shared memory, each CTA marking in its own marks; `ends` goes
//   to both CTAs, the lists' lengths to rank 0. A cluster barrier; each
//   CTA ORs the peer's 8 KB of marks into its own in one sweep. The
//   repairs, from a second counter of rank 0's. A cluster barrier; rank 0
//   runs the serial parse where a repair's list filled, else stitches. The
//   64 warps size the pieces (rank 1 reading rank 0's table), warp 0 of
//   rank 0 turns the sizes into offsets, and the 64 warps write them; a
//   cluster barrier between each. Only the part boundaries and the joins
//   differ from width 1, and the joins follow the reference's parse, so
//   the bytes are the same at either width.
// - Within a parse the warp runs the machine in lockstep and shares the
//   wide work: the back count (32 bytes a step) and the forward count
//   (128 bytes a step) together, a ballot finding each first mismatch;
//   the pattern counts 128 bytes a step (their 3-byte rotated tails byte
//   by byte); a chain walk that cannot take the repeat-pattern path goes
//   32 candidates a step, the walk ahead a tight chain of delta loads,
//   then every lane's candidate bytes at once, scored in chain order, each
//   against the running best, as the serial loop scores them.
// - The write-out: the pieces' sizes, their offsets, then each warp
//   writes its pieces; literals and length bytes lane-strided. Nothing is
//   written past the output row. The stitch walks shared memory alone:
//   the warp that lists a part's sequences also notes its last match's
//   end and, after a repair, where the joined list reaches the join.
//
// How it keeps byte parity: the delta table equals the serial inserts'
// table at every search (tests/test_torch_encode_hc_lockstep.py checks
// it); a speculative parse is joined only at a state-0 turn at a position
// it searched from, past which its sequences are the true parse's; every
// chain is walked in the reference's order, each candidate scored against
// the running best; the repeat-pattern path, where the next candidate
// depends on the scoring, goes one candidate a step as the reference
// does.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHashLog = 15;
constexpr int kHeads = 1 << kHashLog;
constexpr int kChain = 1 << 16;
constexpr uint32_t kHashMul = 2654435761u;
constexpr uint16_t kEmpty = 0xFFFF;
constexpr int kWindow = 65535;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;
constexpr int kOptimalMl = 18;
constexpr int kWarps = 32;   // warps of a CTA (one hash class each)
constexpr int kParts = 128;  // speculative parses of a CTA of a block
constexpr int kMaxWidth = 2;  // CTAs of a block (the launch's cluster)
constexpr int kMaxParts = kParts * kMaxWidth;
constexpr int kMaxPieces = 2 * kMaxParts + 1;  // of the stitched stream
constexpr int kThreads = 32 * kWarps;
constexpr int kRowPad = 64;  // zero bytes after the row (reads reach < 8)
constexpr int kRowBytes = kChain + kRowPad;
constexpr int kMarkWords = kChain / 32;  // a bit per position
constexpr int kCounts = 16;  // LZ4T_B5_COUNT's counts per block
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoSlot = 1u << kHashLog;  // a key no hash equals

static_assert(kHeads * 2 <= kRowBytes, "the head table lives in the row");

// Cost-split variants (lz4_tpu_torch/probes/b5_split.py), not for use:
// LZ4T_B5_NOEMIT writes no output byte (op still advances),
// LZ4T_B5_PREPASS stops after the pre-pass and the row copy,
// LZ4T_B5_COUNT writes, for each block, the searches, candidates,
// candidates scored in full and bytes compared of all its parses; the SM
// cycles (clock64) of its pre-pass, of its parses (summed over the
// warps), their searches and full scores, and of the whole block; whether
// it fell back to the serial parse; the repairs' sequences written out;
// and the cycles of the write-out, to the buffer given to
// lz4t_encode_hc_counts; then the wall cycles of the speculative parses,
// of the repairs and of the serial parse, and the block's width (the CTAs
// that parsed it).
#ifdef LZ4T_B5_NOEMIT
constexpr bool kEmit = false;
#else
constexpr bool kEmit = true;
#endif
#ifdef LZ4T_B5_PREPASS
constexpr bool kParse = false;
#else
constexpr bool kParse = true;
#endif
#ifdef LZ4T_B5_COUNT
constexpr bool kCount = true;
#else
constexpr bool kCount = false;
#endif

__device__ __forceinline__ uint32_t hash4(uint32_t seq) {
  return (seq * kHashMul) >> (32 - kHashLog);
}

// The block's row in shared memory, zero past cap_n.
struct Row {
  const uint32_t* w;
  const uint8_t* b;

  __device__ __forceinline__ uint32_t byte(int q) const { return b[q]; }
  __device__ __forceinline__ uint32_t read4(int q) const {
    const int i = q >> 2;
    return __funnelshift_r(w[i], w[i + 1], (q & 3) * 8);
  }
  // 16-bit read with its address clamped at 0 (the can-beat filter)
  __device__ __forceinline__ uint32_t read16c(int q) const {
    return read4(max(q, 0)) & 0xFFFFu;
  }
};

// The lanes whose key equals this lane's (keys below 2^16), from one
// ballot per key bit: what __match_any_sync gives, at a fraction of its
// cost when the keys are mostly distinct.
__device__ __forceinline__ unsigned same_key(uint32_t key) {
  unsigned grp = kFull;
#pragma unroll
  for (int bit = 0; bit <= kHashLog; ++bit) {
    const bool one = (key >> bit) & 1u;
    const unsigned m = __ballot_sync(kFull, one);
    grp &= one ? m : ~m;
  }
  return grp;
}

// 4 bytes of the row in device memory at q (0 past cap).
__device__ __forceinline__ uint32_t global4(const uint8_t* row, int cap,
                                            int q) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (q + k < cap) v |= static_cast<uint32_t>(__ldg(row + q + k)) << (8 * k);
  return v;
}

// Word k of the row in device memory (bytes 4k..4k+3, 0 past cap): one
// load where the row is 4-byte aligned and the word lies inside it.
__device__ __forceinline__ uint32_t global_word(const uint8_t* row, int cap,
                                                int k, bool aligned) {
  if (aligned && 4 * k + 4 <= cap)
    return __ldg(reinterpret_cast<const uint32_t*>(row) + k);
  return global4(row, cap, 4 * k);
}

// The pre-pass by the whole CTA: chain[q] = q - prev(q) for q < npos
// (head cleared to kEmpty; warp c owns the slots h with h % kWarps == c,
// so no two warps touch one slot). A window of kThreads positions a step:
// (1) each thread hashes its position, and the lanes of a warp that share
// a class count themselves; (2) warp c turns the counts of class c into
// offsets; (3) each thread puts (q, h) into the window's array sorted by
// class, in position order within a class; (4) warp c walks its class's
// entries in order, 32 a step: a lane takes the highest lower lane of its
// slot, else the table; the highest lane of each slot writes. Three barriers
// a window; the row's words for the next window load during this one.
struct PrepassScratch {
  uint32_t arr[2][kThreads];   // (q | h << 16) by class, double-buffered
  int cnt[2][kWarps][kWarps];  // [warp][class]: counts, then offsets
  int tot[kWarps];             // each class's entries in the window
};

__device__ __forceinline__ void prepass_cta(const uint8_t* row, int cap,
                                            int npos, uint16_t* head,
                                            uint16_t* chain,
                                            PrepassScratch& ps, int w,
                                            int lane) {
  static_assert((kWarps & (kWarps - 1)) == 0 && kWarps <= 32,
                "classes are the low bits of a slot");
  const unsigned below = (1u << lane) - 1u;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  for (int i = threadIdx.x; i < 2 * kWarps * kWarps; i += blockDim.x)
    (&ps.cnt[0][0][0])[i] = 0;
  __syncthreads();
  auto load = [&](int q) -> uint32_t {
    if (q >= npos) return 0u;
    const int k = q >> 2;
    return __funnelshift_r(global_word(row, cap, k, aligned),
                           global_word(row, cap, k + 1, aligned),
                           (q & 3) * 8);
  };
  uint32_t seq = load(threadIdx.x);
  int p = 0;
#pragma unroll 1
  for (int base = 0; base < npos; base += kThreads, p ^= 1) {
    const int q = base + threadIdx.x;
    const bool live = q < npos;
    const uint32_t nseq = load(q + kThreads);  // the next window's bytes
    const uint32_t h = hash4(seq);
    const int cls = h & (kWarps - 1);
    // (1) the lanes of this warp in the same class (dead lanes: none)
    unsigned grp = __ballot_sync(kFull, live);
    if (!live) grp = 1u << lane;
#pragma unroll
    for (int bit = 1; bit < kWarps; bit <<= 1) {
      const bool one = cls & bit;
      const unsigned m = __ballot_sync(kFull, one);
      if (live) grp &= one ? m : ~m;
    }
    const int rank = __popc(grp & below);
    if (live && rank == 0) ps.cnt[p][w][cls] = __popc(grp);
    __syncthreads();
    // (2) warp c: offsets of class c over the warps, and its total
    int run = lane < kWarps ? ps.cnt[p][lane][w] : 0;
    const int own = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run += v;
    }
    if (lane < kWarps) ps.cnt[p][lane][w] = run - own;
    if (lane == 31) ps.tot[w] = run;
    __syncthreads();
    // (3) each thread's place in the window sorted by class
    int start = lane < kWarps ? ps.tot[lane] : 0;
    const int tl = start;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, start, d);
      if (lane >= d) start += v;
    }
    start -= tl;  // lane c: where class c starts
    const int cstart = __shfl_sync(kFull, start, cls);
    const int ctot = __shfl_sync(kFull, tl, w);
    const int mine = __shfl_sync(kFull, start, w);
    if (live)
      ps.arr[p][cstart + ps.cnt[p][w][cls] + rank] =
          static_cast<uint32_t>(q) | (h << 16);
    __syncthreads();
    // the counts' table of this window is read: clear it for window + 2
    for (int i = threadIdx.x; i < kWarps * kWarps; i += blockDim.x)
      (&ps.cnt[p][0][0])[i] = 0;
    // (4) warp w walks class w's entries in order
    for (int i0 = 0; i0 < ctot; i0 += 32) {
      const bool on = i0 + lane < ctot;
      const uint32_t x = on ? ps.arr[p][mine + i0 + lane] : 0u;
      const int qq = static_cast<int>(x & 0xFFFFu);
      const uint32_t hh = on ? x >> 16 : kNoSlot + lane;
      const int e = on ? head[hh] : kEmpty;
      // a chunk of one slot (a run of equal bytes) needs no key ballots
      const uint32_t h0 = __shfl_sync(kFull, hh, 0);
      const unsigned live = __ballot_sync(kFull, on);
      const bool one_slot = __all_sync(kFull, !on || hh == h0);
      const unsigned g =
          one_slot ? (on ? live : 1u << lane) : same_key(hh);
      const unsigned lower = g & below;
      const int eq = __shfl_sync(kFull, qq, lower ? 31 - __clz(lower) : lane);
      const int prev = lower ? eq : (e == kEmpty ? -1 : e);
      if (on) chain[qq] = static_cast<uint16_t>(prev < 0 ? 0 : qq - prev);
      __syncwarp();
      if (on && (g >> lane) == 1u) head[hh] = static_cast<uint16_t>(qq);
      __syncwarp();
    }
    seq = nseq;
  }
  __syncthreads();
}

// The output row, written by the warp; nothing past cap.
struct Sink {
  uint8_t* p;
  int op;
  int cap;
  int lane;
  int trail = 0;  // the final literal run's length

  __device__ __forceinline__ void at(int i, uint32_t v) const {
    if (kEmit && i < cap) p[i] = static_cast<uint8_t>(v);
  }
  __device__ __forceinline__ void put(uint32_t v) {
    if (lane == 0) at(op, v);
    ++op;
  }
  // continuation bytes of a length field holding ln = value - 15
  __device__ __forceinline__ void len(int ln) {
    const int k = ln / 255;
    for (int i = lane; i <= k; i += 32) at(op + i, i < k ? 255 : ln - 255 * k);
    op += k + 1;
  }
  __device__ __forceinline__ void literals(const Row& r, int a, int n) {
    for (int i = lane; i < n; i += 32) at(op + i, r.byte(a + i));
    op += n;
  }
  // one sequence: [anchor, ip) literals, then the match (off, mlen)
  __device__ __forceinline__ void sequence(const Row& r, int anchor, int ip,
                                           int off, int mlen) {
    const int litlen = ip - anchor;
    const int mlc = mlen - kMinMatch;
    put((min(litlen, 15) << 4) | min(mlc, 15));
    if (litlen >= 15) len(litlen - 15);
    literals(r, anchor, litlen);
    put(off & 255);
    put(off >> 8);
    if (mlc >= 15) len(mlc - 15);
  }
  // the final literal run, [anchor, n)
  __device__ __forceinline__ void tail(const Row& r, int anchor, int n) {
    trail = max(n - anchor, 0);
    put(min(trail, 15) << 4);
    if (trail >= 15) len(trail - 15);
    literals(r, anchor, trail);
  }
};

struct Match {
  int len;
  int off;  // 0: nothing beat the given length
  int back;
};

// The parse's searches, run by the whole warp in lockstep.
struct Parser {
  Row r;
  const uint16_t* chain;
  int matchlimit;
  int depth;
  bool favor;
  int lane;
  // LZ4T_B5_COUNT: searches, candidates, candidates scored in full, bytes
  // compared; cycles of the pre-pass, the parse, its searches and scores
  unsigned long long cnt[kCounts] = {};

  // Equal bytes going back from (p, c), at most kmax, from k0 on.
  __device__ __forceinline__ int back_count(int p, int c, int kmax, int k0) const {
    for (int k = k0; k < kmax; k += 32) {
      const int i = k + lane;
      const bool stop = i >= kmax || r.byte(p - 1 - i) != r.byte(c - 1 - i);
      const unsigned m = __ballot_sync(kFull, stop);
      if (m) return k + __ffs(m) - 1;
    }
    return kmax;
  }

  // Equal bytes at q1 + i and q2 + i, i < maxn, from c0 on.
  __device__ __forceinline__ int fwd_count(int q1, int q2, int maxn, int c0) const {
    for (int c = c0; c < maxn; c += 128) {
      const int ci = c + 4 * lane;
      int good = 0;
      if (ci < maxn) {
        const uint32_t x = r.read4(q1 + ci) ^ r.read4(q2 + ci);
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

  // Score candidate c for a search at pos: the back-extension (at most
  // maxb bytes) plus 4 plus the forward count to matchlimit, their first
  // steps together.
  __device__ __forceinline__ void score(int pos, int c, int maxb, int& tot, int& bk) {
    const long long t0 = kCount ? clock64() : 0;
    const int q1 = pos + kMinMatch;
    const int q2 = c + kMinMatch;
    const int maxn = matchlimit - q1;
    const bool bstop =
        lane >= maxb || r.byte(pos - 1 - lane) != r.byte(c - 1 - lane);
    int good = 0;
    if (4 * lane < maxn) {
      const uint32_t x = r.read4(q1 + 4 * lane) ^ r.read4(q2 + 4 * lane);
      good = min(x ? (__ffs(x) - 1) >> 3 : 4, maxn - 4 * lane);
    }
    const unsigned mb = __ballot_sync(kFull, bstop);
    const unsigned mf = __ballot_sync(kFull, good < 4);
    bk = mb ? __ffs(mb) - 1 : back_count(pos, c, maxb, 32);
    int fc;
    if (mf) {
      const int f = __ffs(mf) - 1;
      fc = 4 * f + __shfl_sync(kFull, good, f);
    } else {
      fc = fwd_count(q1, q2, maxn, 128);
    }
    tot = kMinMatch + fc + bk;
    if (kCount) {
      cnt[3] += fc + bk;
      cnt[7] += clock64() - t0;
    }
  }

  // run length of the repeating 4-byte pattern starting at q
  __device__ __forceinline__ int count_pat_fwd(int q, uint32_t pat, int limit) {
    int p = q;
    for (;;) {
      const int pk = p + 4 * lane;
      const bool ok = pk + 4 <= limit && r.read4(pk) == pat;
      const unsigned m = __ballot_sync(kFull, !ok);
      if (m) {
        p += 4 * (__ffs(m) - 1);
        break;
      }
      p += 128;
    }
    uint32_t x = pat;
    for (int k = 0; k < 3; ++k) {
      if (!(p < limit && r.byte(p) == (x & 255u))) break;
      ++p;
      x = (x >> 8) | (x << 24);
    }
    if (kCount) cnt[3] += p - q;
    return p - q;
  }

  // run length of the pattern ending at q, scanning backwards to low
  __device__ __forceinline__ int count_pat_rev(int q, uint32_t pat, int low) {
    int p = q;
    for (;;) {
      const int pk = p - 4 * lane;
      const bool ok = pk >= low + 4 && r.read4(pk - 4) == pat;
      const unsigned m = __ballot_sync(kFull, !ok);
      if (m) {
        p -= 4 * (__ffs(m) - 1);
        break;
      }
      p -= 128;
    }
    uint32_t x = pat;
    for (int k = 0; k < 3; ++k) {
      if (!(p > low && r.byte(max(p - 1, 0)) == (x >> 24))) break;
      --p;
      x = (x << 8) | (x >> 24);
    }
    if (kCount) cnt[3] += q - p;
    return q - p;
  }

  // Widest match at pos that may back-extend to lowpos and beats lg. The
  // head of pos's hash is pos - chain[pos] (every position below pos has
  // been inserted, pos has not).
  __device__ __forceinline__ Match lazy_search(int pos, int lowpos, int lg) {
    if (!kCount) return walk(pos, lowpos, lg);
    const long long t0 = clock64();
    const Match m = walk(pos, lowpos, lg);
    ++cnt[0];
    cnt[6] += clock64() - t0;
    return m;
  }

  // The chain walk where no candidate can take the repeat-pattern path
  // (depth <= 128, or pos's 4 bytes are not periodic): up to 32
  // candidates a step. The walk ahead is a tight chain of delta loads
  // (lane k keeps the k-th candidate); then each lane loads its
  // candidate's bytes, all at once, and the candidates are scored in chain
  // order, each against the running best, as the serial loop scores them:
  // a ballot finds the first candidate that passes the can-beat filter at
  // the current best length, and after its score (which may raise the
  // best) the filter is taken again for the candidates after it.
  __device__ __forceinline__ Match batched(int pos, int lowpos, int lowest,
                                           uint32_t pat, int c, Match best) {
    const int lookback = pos - lowpos;
    uint32_t f1 = r.read16c(lowpos + best.len - 1);
    int tries = depth;
#pragma unroll 1
    while (true) {
      const int kmax = min(32, tries);
      int mine = 0;
      int live = 0;
      int cur = c;
      bool more = true;
#pragma unroll 1
      for (int k = 0; k < kmax; ++k) {
        if (lane == k) mine = cur;
        const int d = chain[cur];
        ++live;
        const int nx = cur - d;
        if (d == 0 || nx < lowest) {
          more = false;
          break;
        }
        cur = nx;
      }
      if (kCount) cnt[1] += live;
      const bool ok = lane < live && r.read4(mine) == pat &&
                      !(favor && pos - mine < 8);
      unsigned rest = __ballot_sync(kFull, ok);
#pragma unroll 1
      while (rest) {
        const bool pass = ((rest >> lane) & 1u) &&
                          r.read16c(mine - lookback + best.len - 1) == f1;
        const unsigned pm = __ballot_sync(kFull, pass);
        if (!pm) break;
        const int f = __ffs(pm) - 1;
        const int cf = __shfl_sync(kFull, mine, f);
        if (kCount) ++cnt[2];
        int tot, bk;
        score(pos, cf, lookback > 0 ? min(lookback, cf) : 0, tot, bk);
        if (tot > best.len) {
          best = Match{tot, pos - cf, bk};
          f1 = r.read16c(lowpos + best.len - 1);
        }
        rest &= ~((2u << f) - 1u);  // the candidates after f
      }
      tries -= live;
      if (!more || tries <= 0) break;
      c = cur;
    }
    return best;
  }

  // Widest match at pos that may back-extend to lowpos and beats lg (see
  // lazy_search). At depth > 128 a periodic pattern (period 1 or 2) may
  // take the repeat-pattern path, where the next candidate depends on the
  // scoring: that walk goes one candidate a step, as the reference's.
  __device__ __forceinline__ Match walk(int pos, int lowpos, int lg) {
    Match best{lg, 0, 0};
    const uint32_t pat = r.read4(pos);
    const int d0 = chain[pos];
    const int lowest = max(pos - kWindow, 0);
    const int lookback = pos - lowpos;
    if (d0 == 0 || pos - d0 < lowest) return best;
    const bool pa = depth > 128;
    const bool periodic =
        (pat & 0xFFFFu) == (pat >> 16) && (pat & 255u) == (pat >> 24);
    if (!(pa && periodic))
      return batched(pos, lowpos, lowest, pat, pos - d0, best);
    int c = pos - d0;
    int spl = -1;  // source-side run length of the pattern, once needed
    uint32_t f1 = r.read16c(lowpos + best.len - 1);
#pragma unroll 1
    for (int tries = depth; tries > 0; --tries) {
      if (kCount) ++cnt[1];
      // candidate c's filter loads and its chain delta, one round trip
      const int dlt = chain[c];
      const uint32_t f2 = r.read16c(c - lookback + best.len - 1);
      const uint32_t m = r.read4(c);
      if (f1 == f2 && m == pat && !(favor && pos - c < 8)) {
        if (kCount) ++cnt[2];
        int tot, bk;
        score(pos, c, lookback > 0 ? min(lookback, c) : 0, tot, bk);
        if (tot > best.len) {
          best = Match{tot, pos - c, bk};
          f1 = r.read16c(lowpos + best.len - 1);
        }
      }
      // next candidate
      bool applies = false;
      const int cand = c - 1;
      if (c > 0 && dlt == 1) {
        if (spl < 0)
          spl = count_pat_fwd(pos + kMinMatch, pat, matchlimit) + kMinMatch;
        applies = cand >= lowest && r.read4(max(cand, 0)) == pat;
      }
      int nc;
      bool dead;
      if (applies) {
        const int fwd_pat =
            count_pat_fwd(cand + kMinMatch, pat, matchlimit) + kMinMatch;
        int back_pat = count_pat_rev(cand, pat, 0);
        if (cand - back_pat < lowest) back_pat = cand - lowest;
        const int seg = back_pat + fwd_pat;
        const int c_nf = cand - back_pat;
        if (seg >= spl && fwd_pat <= spl) {
          nc = cand + fwd_pat - spl;
          dead = nc < lowest;
        } else if (lookback == 0) {
          bool brk = false;
          const int max_ml = min(seg, spl);
          if (best.len < max_ml) {
            if (pos - c_nf > kWindow) {
              brk = true;
            } else {
              best = Match{max_ml, pos - c_nf, 0};
              f1 = r.read16c(lowpos + best.len - 1);
            }
          }
          const int dlt2 = chain[max(c_nf, 0)];
          nc = c_nf - dlt2;
          dead = brk || dlt2 == 0 || nc < lowest;
        } else {
          nc = c_nf;
          dead = c_nf < lowest;
        }
      } else {
        nc = c - dlt;
        dead = dlt == 0 || nc < lowest;
      }
      if (dead) break;
      c = nc;
    }
    return best;
  }
};

// Copy row (cap bytes in device memory) to shared memory, zero after it
// up to the reads' reach (the whole CTA).
__device__ __forceinline__ void load_row(const uint8_t* row, int cap,
                                         uint8_t* dst) {
  const int end = min(kRowBytes, ((cap + 3) & ~3) + kRowPad);
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nv = cap >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(row);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) d[i] = __ldg(s + i);
    i0 = nv << 4;
  }
  for (int i = i0 + threadIdx.x; i < end; i += blockDim.x)
    dst[i] = i < cap ? __ldg(row + i) : 0;
}

// A sequence as the lists keep it: its match start and length (16 bits
// each; its literals run from the previous sequence's end) and offset.
__device__ __forceinline__ uint2 seq_entry(int start, int mlen, int off) {
  return make_uint2(static_cast<uint32_t>(start) |
                        (static_cast<uint32_t>(mlen) << 16),
                    static_cast<uint32_t>(off));
}

// What the machine does at its state-0 turns and with its sequences.
enum Mode { kSpec, kRepair, kSerial };

// One run of the Search2/Search3 machine (the whole warp) from state 0 at
// ip. kSpec: a speculative parse of [ip, hi): stops at its first state-0
// turn at or past hi, marking every state-0 position it searches from,
// and lists its sequences (when the list fills, it stops and falls back
// to its last state-0 turn). kRepair: the true parse from ip up to the
// first valid mark (a mark below its owner's end), listing its sequences
// (a full list sets *overflow). kSerial: the whole parse, written out as
// it goes. Returns the state-0 position it stopped at (> mflimit: the
// block's end); *len is the list's length, *sync the mark a repair closed
// on (-1: none). Which sequences follow a state-0 turn depends on its
// position alone: that is what lets the parses join.
__device__ __forceinline__ int machine(Parser& ps, Sink& o, Mode mode, int ip,
                                       int hi, int mflimit, int seg,
                                       uint2* list, int cap, int* len,
                                       int* sync, bool* overflow,
                                       uint32_t* marks, const int* ends) {
  const Row& r = ps.r;
  const int lane = ps.lane;
  int n_list = 0;
  int last_ip = ip, last_len = 0;  // kSpec: the last state-0 turn
  bool full = false;
  int anchor = ip;                 // kSerial: where the literals start
  *sync = -1;
  // m1 at ip is the current match (m0 at s0 its saved copy), m2 at s2 the
  // overlapping second, m3 at s3 the third. One search a turn.
  int state = 0;
  int s0 = 0, s2 = 0;
  Match m1{0, 0, 0}, m0{0, 0, 0}, m2{0, 0, 0};
  auto commit = [&](int start, int mlen, int off) {
    if (mode == kSerial) {
      o.sequence(r, anchor, start, off, mlen);
      anchor = start + mlen;
    } else if (n_list < cap) {
      if (lane == 0) list[n_list] = seq_entry(start, mlen, off);
      ++n_list;
    } else {
      full = true;
    }
  };
#pragma unroll 1
  while (true) {
    int pos, lowpos, lg;
    bool can;
    if (state == 0) {  // scan for a first match at ip
      if (ip > mflimit) break;
      if (mode == kSpec) {
        if (full || ip >= hi) break;
        if (lane == 0) atomicOr(&marks[ip >> 5], 1u << (ip & 31));
        last_ip = ip;
        last_len = n_list;
      } else if (mode == kRepair) {
        const bool marked = (marks[ip >> 5] >> (ip & 31)) & 1u;
        if (marked && ip < ends[ip / seg]) {
          *sync = ip;
          break;
        }
      }
      pos = lowpos = ip;
      lg = kMinMatch - 1;
      can = true;
    } else if (state == 1) {  // Search2: a wider overlapping match
      can = ip + m1.len <= mflimit;
      pos = ip + m1.len - 2;
      lowpos = ip;
      lg = m1.len;
    } else {  // Search3: a third match past m2
      if (s2 - ip < kOptimalMl) {  // pre-trim m1 against m2
        int nml = min(m1.len, kOptimalMl);
        if (ip + nml > s2 + m2.len - kMinMatch)
          nml = s2 - ip + m2.len - kMinMatch;
        const int corr = nml - (s2 - ip);
        if (corr > 0) {
          s2 += corr;
          m2.len -= corr;
        }
      }
      can = s2 + m2.len <= mflimit;
      pos = s2 + m2.len - 3;
      lowpos = s2;
      lg = m2.len;
    }
    const Match m = can ? ps.lazy_search(pos, lowpos, lg) : Match{lg, 0, 0};
    if (state == 0) {
      if (m.len >= kMinMatch && m.off > 0) {
        m1 = m;
        m0 = m;
        s0 = ip;
        state = 1;
      } else {
        ++ip;
      }
    } else if (state == 1) {
      m2 = m;
      s2 = pos - m2.back;
      if (!(can && m2.len > m1.len && m2.off > 0)) {
        commit(ip, m1.len, m1.off);  // nothing wider: commit m1
        ip += m1.len;
        state = 0;
        continue;
      }
      if (s0 < ip && s2 < ip + m0.len) {  // restore the saved m0
        ip = s0;
        m1 = m0;
      }
      if (s2 - ip < 3) {  // m1 too small: drop it, search again
        ip = s2;
        m1 = m2;
      } else {
        state = 2;
      }
    } else {
      const Match m3 = m;
      const int s3 = pos - m3.back;
      if (!(can && m3.len > m2.len && m3.off > 0)) {
        // no better third: m1 (cut at s2), then m2
        if (s2 < ip + m1.len) m1.len = s2 - ip;
        commit(ip, m1.len, m1.off);
        commit(s2, m2.len, m2.off);
        ip = s2 + m2.len;
        state = 0;
      } else if (s3 < ip + m1.len + 3) {
        if (s3 >= ip + m1.len) {
          // m2 dies: commit m1; m3 becomes m1 and m2's rest the saved m0
          if (s2 < ip + m1.len) {
            const int corr = ip + m1.len - s2;
            s2 += corr;
            m2.len -= corr;
          }
          if (m2.len < kMinMatch) {
            s2 = s3;
            m2 = m3;
          }
          commit(ip, m1.len, m1.off);
          ip = s3;
          m1 = m3;
          s0 = s2;
          m0 = m2;
          state = 1;
        } else {  // m3 replaces m2
          s2 = s3;
          m2 = m3;
        }
      } else {
        // three ascending matches: commit a trimmed m1, shift down
        if (s2 < ip + m1.len) {
          if (s2 - ip < kOptimalMl) {
            m1.len = min(m1.len, kOptimalMl);
            if (ip + m1.len > s2 + m2.len - kMinMatch)
              m1.len = s2 - ip + m2.len - kMinMatch;
            const int corr = m1.len - (s2 - ip);
            if (corr > 0) {
              s2 += corr;
              m2.len -= corr;
            }
          } else {
            m1.len = s2 - ip;
          }
        }
        commit(ip, m1.len, m1.off);
        ip = s2;
        m1 = m2;
        s2 = s3;
        m2 = m3;
      }
    }
  }
  if (mode == kSpec && full) {  // back to the last state-0 turn
    ip = last_ip;
    n_list = last_len;
  }
  *overflow = mode == kRepair && full;
  if (mode == kSerial) o.tail(r, anchor, ps.matchlimit + kLastLiterals);
  *len = n_list;
  return ip;
}

// Write out list[from, to) (the whole warp), the literals of its first
// sequence from *prev; *prev becomes the last one's end. 32 entries are
// loaded at a time, one per lane.
__device__ __forceinline__ void emit_list(Sink& o, const Row& r,
                                          const uint2* list, int from, int to,
                                          int* prev) {
  const int lane = o.lane;
  for (int base = from; base < to; base += 32) {
    const int cnt = min(32, to - base);
    const uint2 e = lane < cnt ? list[base + lane] : make_uint2(0u, 0u);
    for (int k = 0; k < cnt; ++k) {
      const uint32_t x = __shfl_sync(kFull, e.x, k);
      const int off = static_cast<int>(__shfl_sync(kFull, e.y, k));
      const int start = static_cast<int>(x & 0xFFFFu);
      const int mlen = static_cast<int>(x >> 16);
      o.sequence(r, *prev, start, off, mlen);
      *prev = start + mlen;
    }
  }
}

// The first entry of list[0, len) whose match starts at or past pos.
__device__ __forceinline__ int first_from(const uint2* list, int len, int pos,
                                          int lane) {
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    const bool at = i < len && static_cast<int>(list[i].x & 0xFFFFu) >= pos;
    const unsigned m = __ballot_sync(kFull, at);
    if (m) return base + __ffs(m) - 1;
  }
  return len;
}

// Per-CTA shared state besides the tables. At width 2, rank 0's holds
// the pair's counters, lists' lengths, joins and flags; `ends` is kept in
// both CTAs.
struct alignas(16) Meta {
  int ends[kMaxParts];      // where each speculative parse stopped
  int spec_len[kMaxParts];  // its list's length
  int sync[kMaxParts];      // the mark the repair after it closed on (-1: none)
  int rep_len[kMaxParts];   // that repair's list's length
  // what the stitch reads of the lists, found by the warp that wrote them:
  int spec_end[kMaxParts];  // the end of the speculative list's last match
  int rep_end[kMaxParts];   // the same of the repair's list
  int join[kMaxParts];      // the first entry of the joined list past sync
  int next[2];              // the next part to take, in phases 0 and 1
  int overflow;             // a repair's list filled: parse serially
  int npieces;              // the stream's pieces
  int tail_at;              // the final literal run's start
  int total;                // the pieces' bytes
  unsigned long long cnt[kCounts];  // LZ4T_B5_COUNT
};

// The stitched stream's pieces, in order (rank 0's at width 2).
struct Pieces {
  int4 piece[kMaxPieces];  // (list offset, from, to, literal start)
  int poff[kMaxPieces];    // their sizes, then their output offsets
};

// The pre-pass's scratch and the pieces are never live together.
union Scratch {
  PrepassScratch pre;
  Pieces pc;
};

constexpr int kSmemBytes = kChain * 2 + kRowBytes + kMarkWords * 4 +
                           static_cast<int>(sizeof(Meta)) +
                           static_cast<int>(sizeof(Scratch));
static_assert(kSmemBytes <= 232448, "over a CTA's shared memory");
static_assert((kChain * 2 + kRowBytes + kMarkWords * 4) % 16 == 0 &&
                  sizeof(Meta) % 16 == 0,
              "Meta and Scratch start 16-byte aligned");

// The stitch (warp 0 of rank 0, from shared memory alone): part 0's
// list, then, in turn, the repair after the parse the true one follows
// and the suffix of the parse that repair joined, each piece with the
// start of its first sequence's literals.
__device__ __forceinline__ void stitch(Meta& meta, Pieces& pcs, int parts,
                                       int spec_cap, int rep_cap, int seg,
                                       int mflimit, int lane) {
  int np = 0;
  int prev = 0;
  auto add = [&](int off, int from, int to, int end) {
    if (lane == 0) pcs.piece[np] = make_int4(off, from, to, prev);
    ++np;
    if (to > from) prev = end;
  };
  add(0, 0, meta.spec_len[0], meta.spec_end[0]);
  int v = 0;  // the parse the true one follows up to its end
  while (meta.ends[v] <= mflimit) {
    add(parts * spec_cap + v * rep_cap, 0, meta.rep_len[v], meta.rep_end[v]);
    const int at = meta.sync[v];
    if (at < 0) break;
    const int u = at / seg;
    add(u * spec_cap, meta.join[v], meta.spec_len[u], meta.spec_end[u]);
    v = u;
  }
  if (lane == 0) {
    meta.npieces = np;
    meta.tail_at = prev;
  }
}

// Bytes of the piece pc's sequences as written out (the whole warp, 32
// sequences a step).
__device__ __forceinline__ int piece_size(const int4 pc, const uint2* lists,
                                          int lane) {
  const uint2* list = lists + pc.x;
  int prev = pc.w;
  int sz = 0;
  for (int base = pc.y; base < pc.z; base += 32) {
    const int cnt = min(32, pc.z - base);
    const uint32_t x = lane < cnt ? list[base + lane].x : 0u;
    const int start = static_cast<int>(x & 0xFFFFu);
    const int mlen = static_cast<int>(x >> 16);
    const int end = start + mlen;
    const int before = __shfl_up_sync(kFull, end, 1);
    const int lit = start - (lane == 0 ? prev : before);
    const int mlc = mlen - kMinMatch;
    int s = 0;
    if (lane < cnt)
      s = 3 + lit + (lit >= 15 ? (lit - 15) / 255 + 1 : 0) +
          (mlc >= 15 ? (mlc - 15) / 255 + 1 : 0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    sz += s;
    prev = __shfl_sync(kFull, end, cnt - 1);
  }
  return sz;
}

// The pieces' sizes into their output offsets, and the total (one warp).
__device__ __forceinline__ void piece_offsets(Meta& meta, Pieces& pcs,
                                              int lane) {
  int at = 0;
  for (int base = 0; base < meta.npieces; base += 32) {
    const int k = base + lane;
    const int sz = k < meta.npieces ? pcs.poff[k] : 0;
    int run = sz;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run += v;
    }
    if (k < meta.npieces) pcs.poff[k] = at + run - sz;
    at += __shfl_sync(kFull, run, 31);
  }
  if (lane == 0) meta.total = at;
}

// Every thread of the block's CTAs: the cluster's barrier at width 2
// (release and acquire, so shared memory written before it, the peer's
// too, is seen after it), else the CTA's.
template <int W>
__device__ __forceinline__ void sync_all(cg::cluster_group& cluster) {
  if constexpr (W > 1)
    cluster.sync();
  else
    __syncthreads();
}

// x in the CTA of the given rank (x itself at width 1).
template <int W, typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cluster, T* x,
                                      unsigned rank) {
  if constexpr (W > 1)
    return cluster.map_shared_rank(x, rank);
  else
    return x;
}

// The kernel's body at width W: each block on W CTAs (the launch's
// cluster; one CTA of kWarps warps an SM), looping over blocks. Per block:
// the pre-pass and the row copy (each CTA its own), the speculative parses
// and then the repairs (the block's kParts x W parts, which the warps of
// its CTAs take in turn from rank 0's counters), the stitch (warp 0 of
// rank 0), and the write-out (each warp of the block its share of the
// pieces).
template <int W>
__device__ __forceinline__ void encode_blocks(
    const uint8_t* __restrict__ src, const int* __restrict__ lens,
    uint8_t* __restrict__ out, int* __restrict__ csizes,
    int* __restrict__ trailing, uint2* __restrict__ lists, int B, int cap_n,
    int out_w, int depth, int favor, int spec_cap, int rep_cap,
    unsigned long long* __restrict__ counts, unsigned char* smem) {
  uint16_t* chain = reinterpret_cast<uint16_t*>(smem);
  uint8_t* rowb = smem + kChain * sizeof(uint16_t);
  uint16_t* head = reinterpret_cast<uint16_t*>(rowb);  // pre-pass only
  uint32_t* marks = reinterpret_cast<uint32_t*>(rowb + kRowBytes);
  Meta& meta = *reinterpret_cast<Meta*>(marks + kMarkWords);
  Scratch& scr = *reinterpret_cast<Scratch*>(&meta + 1);

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = W > 1 ? cluster.block_rank() : 0u;
  constexpr int parts = kParts * W;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  uint2* blk_lists = lists + static_cast<size_t>(blockIdx.x / W) * parts *
                                 (spec_cap + rep_cap);

#pragma unroll 1
  for (int b = blockIdx.x / W; b < B; b += gridDim.x / W) {
    const long long t0 = kCount ? clock64() : 0;
    const int n = min(max(lens[b], 0), cap_n);
    const int mflimit = n - kMfLimit;
    const int npos = max(mflimit + 1, 0);  // positions a search can reach
    const int seg = max((npos + parts - 1) / parts, 1);
    const uint8_t* row = src + static_cast<size_t>(b) * cap_n;

    uint4* z = reinterpret_cast<uint4*>(head);
    const uint4 empty = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (int i = threadIdx.x; i < kHeads * 2 / 16; i += blockDim.x)
      z[i] = empty;
    for (int i = threadIdx.x; i < kMarkWords; i += blockDim.x) marks[i] = 0;
    if (threadIdx.x == 0) {
      meta.overflow = 0;
      meta.npieces = 0;
      meta.next[0] = meta.next[1] = 0;
    }
    if (kCount && threadIdx.x < kCounts) meta.cnt[threadIdx.x] = 0;
    __syncthreads();
    prepass_cta(row, cap_n, npos, head, chain, scr.pre, w, lane);
    const long long t1 = kCount ? clock64() : 0;
    load_row(row, cap_n, rowb);
    // both CTAs' tables and counters are ready before either takes a part
    sync_all<W>(cluster);
    if (!kParse) continue;

    Parser ps{Row{reinterpret_cast<const uint32_t*>(rowb), rowb},
              chain,
              n - kLastLiterals,
              depth,
              favor != 0,
              lane};
    Sink o{out + static_cast<size_t>(b) * out_w, 0, out_w, lane};
    const long long t2 = kCount ? clock64() : 0;
    long long tph[3] = {t2, t2, t2};  // LZ4T_B5_COUNT: each phase's end
    // phase 0: the speculative parses; 1: the repairs, the true parse from
    // each speculative parse's end (the block's warps take the parts in
    // turn); 2: where a repair's list filled, the serial parse (warp 0 of
    // rank 0). One call site, so the machine is inlined once.
#pragma unroll 1
    for (int phase = 0; phase < 3; ++phase) {
#pragma unroll 1
      while (true) {
        int k = 0;
        if (phase < 2) {
          if (lane == 0)
            k = atomicAdd(&at_rank<W>(cluster, &meta, 0)->next[phase], 1);
          k = __shfl_sync(kFull, k, 0);
          if (k >= parts) break;
        } else if (!(rank == 0 && w == 0 && meta.overflow)) {
          break;
        }
        const Mode mode = phase == 0 ? kSpec : phase == 1 ? kRepair : kSerial;
        const int lo = min(k * seg, npos);
        uint2* list = blk_lists + (phase == 0
                                       ? static_cast<size_t>(k) * spec_cap
                                       : static_cast<size_t>(parts) * spec_cap +
                                             static_cast<size_t>(k) * rep_cap);
        int len, sync;
        bool overflow;
        const int e = machine(
            ps, o, mode, phase == 0 ? lo : phase == 1 ? meta.ends[k] : 0,
            min(lo + seg, npos), mflimit, seg, list,
            phase == 0 ? spec_cap : rep_cap, &len, &sync, &overflow, marks,
            meta.ends);
        if (phase < 2) {
          Meta* lead = at_rank<W>(cluster, &meta, 0);
          // the end of the list's last match (the entry lane 0 wrote), and
          // where the joined parse's list reaches sync
          int last = -1;
          if (lane == 0 && len > 0) {
            const uint32_t x = list[len - 1].x;
            last = static_cast<int>((x & 0xFFFFu) + (x >> 16));
          }
          if (phase == 1 && sync >= 0) {
            const int u = sync / seg;
            const int j = first_from(blk_lists + static_cast<size_t>(u) *
                                                     spec_cap,
                                     lead->spec_len[u], sync, lane);
            if (lane == 0) lead->join[k] = j;
          }
          if (lane == 0 && phase == 0) {
            meta.ends[k] = e;
            if (W > 1) at_rank<W>(cluster, &meta, rank ^ 1u)->ends[k] = e;
            lead->spec_len[k] = len;
            lead->spec_end[k] = last;
          } else if (lane == 0) {
            lead->sync[k] = sync;
            lead->rep_len[k] = len;
            lead->rep_end[k] = last;
            if (overflow) lead->overflow = 1;
          }
        }
        if (phase == 2) break;
      }
      if (kCount && phase == 1) {
        ps.cnt[5] = clock64() - t2;
        Meta* lead = at_rank<W>(cluster, &meta, 0);
        for (int k = 0; k < kCounts; ++k)
          if (lane == 0 && ps.cnt[k]) atomicAdd(&lead->cnt[k], ps.cnt[k]);
      }
      if (phase < 2) sync_all<W>(cluster);
      if (W > 1 && phase == 0) {
        // the marks of the parts the peer took, ORed in (bits only rise)
        uint4* mine = reinterpret_cast<uint4*>(marks);
        const uint4* theirs = at_rank<W>(cluster, mine, rank ^ 1u);
        for (int i = threadIdx.x; i < kMarkWords / 4; i += blockDim.x) {
          const uint4 a = mine[i], c = theirs[i];
          mine[i] = make_uint4(a.x | c.x, a.y | c.y, a.z | c.z, a.w | c.w);
        }
        __syncthreads();
      }
      if (kCount) tph[phase] = clock64();
    }
    // the write-out (the serial parse has written its stream already):
    // warp 0 of rank 0 stitches the pieces; the block's warps size them,
    // warp 0 of rank 0 turns the sizes into offsets, and the block's warps
    // write them
    const long long t4 = kCount ? clock64() : 0;
    const Meta* lead = at_rank<W>(cluster, &meta, 0);
    Pieces* lead_pc = at_rank<W>(cluster, &scr.pc, 0);
    const int gw = static_cast<int>(rank) * kWarps + w;  // warp of the block
    const bool par = !lead->overflow;
    if (par && rank == 0 && w == 0)
      stitch(meta, scr.pc, parts, spec_cap, rep_cap, seg, mflimit, lane);
    sync_all<W>(cluster);
    const int npieces = par ? lead->npieces : 0;
    for (int k = gw; k < npieces; k += kWarps * W) {
      const int sz = piece_size(lead_pc->piece[k], blk_lists, lane);
      if (lane == 0) lead_pc->poff[k] = sz;
    }
    sync_all<W>(cluster);
    if (par && rank == 0 && w == 0) piece_offsets(meta, scr.pc, lane);
    sync_all<W>(cluster);
    for (int k = gw; k < npieces; k += kWarps * W) {
      const int4 pc = lead_pc->piece[k];
      int prev = pc.w;
      o.op = lead_pc->poff[k];
      emit_list(o, ps.r, blk_lists + pc.x, pc.y, pc.z, &prev);
    }
    if (par && rank == 0 && w == 0) {
      o.op = meta.total;
      o.tail(ps.r, meta.tail_at, n);
    }
    if (rank == 0 && threadIdx.x == 0) {
      csizes[b] = o.op;
      trailing[b] = o.trail;
      if (kCount) {
        meta.cnt[4] = t1 - t0;
        meta.cnt[8] = clock64() - t0;
        meta.cnt[9] = meta.overflow;
        meta.cnt[10] = 0;
        for (int k = 0; k < meta.npieces; ++k)
          meta.cnt[10] += (k & 1) ? scr.pc.piece[k].z - scr.pc.piece[k].y : 0;
        meta.cnt[11] = clock64() - t4;
        meta.cnt[12] = tph[0] - t2;
        meta.cnt[13] = tph[1] - tph[0];
        meta.cnt[14] = tph[2] - tph[1];
        meta.cnt[15] = W;
        for (int k = 0; k < kCounts; ++k)
          counts[kCounts * b + k] = meta.cnt[k];
      }
    }
    // no CTA reads the peer's shared memory past here, or clears its own
    // for the next block, before both are done
    sync_all<W>(cluster);
  }
}

// The launch's width is its cluster's: 2 CTAs a block in a cluster of
// two, 1 otherwise. The body is compiled for each (the same parse, with
// the width's constants folded in).
__global__ void __launch_bounds__(kThreads)
encode_hc_kernel(const uint8_t* __restrict__ src, const int* __restrict__ lens,
                 uint8_t* __restrict__ out, int* __restrict__ csizes,
                 int* __restrict__ trailing, uint2* __restrict__ lists,
                 int B, int cap_n, int out_w, int depth, int favor,
                 int spec_cap, int rep_cap,
                 unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (cg::this_cluster().num_blocks() > 1)
    encode_blocks<2>(src, lens, out, csizes, trailing, lists, B, cap_n, out_w,
                     depth, favor, spec_cap, rep_cap, counts, smem);
  else
    encode_blocks<1>(src, lens, out, csizes, trailing, lists, B, cap_n, out_w,
                     depth, favor, spec_cap, rep_cap, counts, smem);
}

unsigned long long* g_counts = nullptr;  // LZ4T_B5_COUNT's buffer

constexpr int kMaxDevices = 64;
std::atomic<int> g_clusters[kMaxDevices];  // per device: clusters + 1

// A launch of the kernel at width 2: B clusters of two CTAs.
struct PairLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1]{};
  PairLaunch(int B, cudaStream_t st) {
    cfg.gridDim = dim3(2 * B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  PairLaunch(const PairLaunch&) = delete;
};

// The 2-CTA clusters of the kernel device dev holds at once, queried once
// a device (cudaOccupancyMaxActiveClusters at kThreads and kSmemBytes).
cudaError_t pair_clusters(int dev, int* n) {
  if (dev >= 0 && dev < kMaxDevices) {
    const int c = g_clusters[dev].load(std::memory_order_relaxed);
    if (c > 0) {
      *n = c - 1;
      return cudaSuccess;
    }
  }
  PairLaunch l(1, nullptr);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(encode_hc_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveClusters(n, encode_hc_kernel, &l.cfg)) !=
          cudaSuccess)
    return e;
  if (dev >= 0 && dev < kMaxDevices)
    g_clusters[dev].store(*n + 1, std::memory_order_relaxed);
  return cudaSuccess;
}

// The width of a launch of B blocks: 2 (a cluster of two CTAs a block)
// where the device holds B such clusters at once, else 1.
cudaError_t plan(int dev, int B, int* width, int* clusters) {
  const cudaError_t e = pair_clusters(dev, clusters);
  *width = e == cudaSuccess && B <= *clusters ? 2 : 1;
  return e;
}

}  // namespace

// LZ4T_B5_COUNT builds: the device buffer (uint64[B, kCounts]) the next
// launches write their counts to.
extern "C" void lz4t_encode_hc_counts(void* counts) {
  g_counts = static_cast<unsigned long long*>(counts);
}

// Bytes of dynamic shared memory each CTA of the kernel takes.
extern "C" int lz4t_encode_hc_smem() { return kSmemBytes; }

// The current device's 2-CTA clusters of the kernel (*clusters) and the
// width a launch of B blocks runs at (*width); returns the cudaError_t.
extern "C" int lz4t_encode_hc_plan(int B, int* width, int* clusters) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = plan(dev, B, width, clusters);
  return static_cast<int>(e);
}

// HC-encode B blocks at chain depth `depth`; returns the launch's
// cudaError_t (0 on success). Width 2 (B <= the device's 2-CTA clusters):
// 2B CTAs in clusters of two, one block a cluster; width 1: min(B, SMs)
// CTAs, each looping over blocks. The sequence lists are the launch's
// scratch, one region a cluster (CTA at width 1), stream-ordered (the
// default pool keeps the memory for the next launch).
extern "C" int lz4t_encode_hc(const void* src, const void* lens, void* out,
                              void* csizes, void* trailing, int B, int cap_n,
                              int out_w, int depth, int favor, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, width = 1, clusters = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(encode_hc_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes)) != cudaSuccess ||
      (e = plan(dev, B, &width, &clusters)) != cudaSuccess)
    return static_cast<int>(e);
  const int groups = width > 1 ? B : max(1, min(B, sms));
  const int parts = kParts * width;
  const int spec_cap = (cap_n + 4 * parts - 1) / (4 * parts) + 128;
  const int rep_cap = 256;
  cudaMemPool_t pool;
  uint64_t keep = UINT64_MAX;
  void* lists = nullptr;
  if ((e = cudaDeviceGetDefaultMemPool(&pool, dev)) != cudaSuccess ||
      (e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold,
                                   &keep)) != cudaSuccess ||
      (e = cudaMallocAsync(&lists,
                           sizeof(uint2) * groups * parts *
                               (spec_cap + rep_cap),
                           st)) != cudaSuccess)
    return static_cast<int>(e);
  const auto* s8 = static_cast<const uint8_t*>(src);
  const auto* ln = static_cast<const int*>(lens);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* cs = static_cast<int*>(csizes);
  auto* tr = static_cast<int*>(trailing);
  auto* ls = static_cast<uint2*>(lists);
  if (width > 1) {
    PairLaunch l(B, st);
    e = cudaLaunchKernelEx(&l.cfg, encode_hc_kernel, s8, ln, o8, cs, tr, ls,
                           B, cap_n, out_w, depth, favor, spec_cap, rep_cap,
                           g_counts);
  } else {
    encode_hc_kernel<<<groups, kThreads, kSmemBytes, st>>>(
        s8, ln, o8, cs, tr, ls, B, cap_n, out_w, depth, favor, spec_cap,
        rep_cap, g_counts);
  }
  const cudaError_t last = cudaGetLastError();
  if (e == cudaSuccess) e = last;
  const cudaError_t f = cudaFreeAsync(lists, st);
  return static_cast<int>(e != cudaSuccess ? e : f);
}
