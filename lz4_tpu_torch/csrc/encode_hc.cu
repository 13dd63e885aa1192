// B5: LZ4 HC block encoder, levels 3-9, one LZ4 block per CTA.
//
// Replaces: lz4_tpu/block/encode_hc_pallas.py : _hc_kernel (driven by
// _encode_hc_raw and encode_blocks_hc_pallas). The same function, not the
// TPU layout: hash-chain parse with a 2^15-entry head table and 16-bit
// previous-occurrence deltas; the wider-match search (can-beat filter on
// two bytes at the current best's width, addresses clamped at 0; forward
// count to matchlimit; back-extension toward the search's low position);
// the Search2/Search3 overlap arbitration, here an ordinary switch over
// states 0 (scan), 1 (Search2) and 2 (Search3); the repeat-pattern
// analysis at depth > 128 (level 9); favor_dec_speed, which drops
// candidates closer than 8. Inserts run strictly in order and a searched
// position is not inserted. Its streams equal the JAX kernel's, the plain
// version's and the port's C compress_lazy byte for byte.
//
// What bounds it on the card: not bytes. The function reads each source
// byte once and writes each compressed byte once (tens of microseconds at
// 3.35 TB/s for the 48 MB main path); the parse is a serial chain of
// dependent loads (chain walks of up to `depth` candidates per search), so
// latency bounds it, and the parallelism is across blocks.
//
// What the design does about that: both tables live in shared memory, so
// every chain step is a shared-memory access. The TPU scratch is 2^15
// int32 heads with a 14-bit grid tag plus 2^15 int32 words of packed
// deltas, 256 KB, over the 227 KB a CTA may have. No-dict positions are
// below 2^16 and inserts stop before n - 12, so a head is a uint16 with
// 0xFFFF as "empty" (no inserted position reaches it): 64 KB of heads plus
// 128 KB of deltas, 192 KB of dynamic shared memory, cleared per block by
// the CTA's threads. A stale-tag head and an empty head both mean "no
// chain", so the tag is not needed; the delta table is only ever read at
// positions inserted for this block, so it is not cleared. The block's
// bytes stay in device memory (read through the read-only cache; the
// 64 KB row mostly fits the L1 left beside the tables): the tables are
// walked more often than the source. One CTA per SM; thread 0 parses.
// Reads outside the row read 0, and nothing is written past the output
// row.

#include <cstdint>
#include <cuda_runtime.h>

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
constexpr int kThreads = 256;
constexpr int kSmemBytes = (kHeads + kChain) * sizeof(uint16_t);

struct Source {
  const uint8_t* p;  // the block's row, cap bytes
  int cap;

  __device__ __forceinline__ uint32_t byte(int q) const {
    return static_cast<unsigned>(q) < static_cast<unsigned>(cap) ? __ldg(p + q)
                                                                 : 0u;
  }
  __device__ __forceinline__ uint32_t read4(int q) const {
    return byte(q) | (byte(q + 1) << 8) | (byte(q + 2) << 16) |
           (byte(q + 3) << 24);
  }
  // 16-bit read with its address clamped at 0 (the can-beat filter)
  __device__ __forceinline__ uint32_t read16c(int q) const {
    return read4(max(q, 0)) & 0xFFFFu;
  }
};

// Byte writer that never writes past the output row.
struct Sink {
  uint8_t* p;
  int op;
  int cap;

  __device__ __forceinline__ void put(uint32_t v) {
    if (op < cap) p[op] = static_cast<uint8_t>(v);
    ++op;
  }
  // continuation bytes of a length field holding ln = value - 15
  __device__ __forceinline__ void len(int ln) {
    for (; ln >= 255; ln -= 255) put(255);
    put(ln);
  }
  __device__ __forceinline__ void literals(const Source& s, int a, int n) {
    for (int i = 0; i < n; ++i) put(s.byte(a + i));
  }
  // one sequence: [anchor, ip) literals, then the match (off, mlen)
  __device__ __forceinline__ void sequence(const Source& s, int anchor, int ip,
                                           int off, int mlen) {
    const int litlen = ip - anchor;
    const int mlc = mlen - kMinMatch;
    put((min(litlen, 15) << 4) | min(mlc, 15));
    if (litlen >= 15) len(litlen - 15);
    literals(s, anchor, litlen);
    put(off & 255);
    put(off >> 8);
    if (mlc >= 15) len(mlc - 15);
  }
};

struct Match {
  int len;
  int off;  // 0: nothing beat the given length
  int back;
};

struct Parser {
  Source s;
  uint16_t* head;
  uint16_t* chain;
  int matchlimit;
  int depth;
  bool favor;
  int ni;  // next position to insert

  __device__ __forceinline__ uint32_t hash4(uint32_t seq) const {
    return (seq * kHashMul) >> (32 - kHashLog);
  }

  // Insert [ni, b) in order. Re-inserting the current head keeps its link.
  __device__ void insert_upto(int b) {
    for (int q = ni; q < b; ++q) {
      const uint32_t h = hash4(s.read4(q));
      const int e = head[h];
      if (e != q) {
        const int d = e == kEmpty ? 0 : q - e;
        chain[q] = static_cast<uint16_t>(d > 0 && d <= kWindow ? d : 0);
      }
      head[h] = static_cast<uint16_t>(q);
    }
    ni = max(ni, b);
  }

  __device__ int fwd_count(int q1, int q2, int maxn) const {
    int c = 0;
    while (c + 4 <= maxn && s.read4(q1 + c) == s.read4(q2 + c)) c += 4;
    while (c < maxn && s.byte(q1 + c) == s.byte(q2 + c)) ++c;
    return c;
  }

  // run length of the repeating 4-byte pattern starting at q
  __device__ int count_pat_fwd(int q, uint32_t pat, int limit) const {
    int p = q;
    while (p + 4 <= limit && s.read4(p) == pat) p += 4;
    uint32_t x = pat;
    for (int k = 0; k < 3; ++k) {
      if (!(p < limit && s.byte(p) == (x & 255u))) break;
      ++p;
      x = (x >> 8) | (x << 24);
    }
    return p - q;
  }

  // run length of the pattern ending at q, scanning backwards to low
  __device__ int count_pat_rev(int q, uint32_t pat, int low) const {
    int p = q;
    while (p >= low + 4 && s.read4(p - 4) == pat) p -= 4;
    uint32_t x = pat;
    for (int k = 0; k < 3; ++k) {
      if (!(p > low && s.byte(max(p - 1, 0)) == (x >> 24))) break;
      --p;
      x = (x << 8) | (x >> 24);
    }
    return q - p;
  }

  // Widest match at pos that may back-extend to lowpos and beats lg;
  // positions [ni, pos) are inserted first, pos is not.
  __device__ Match lazy_search(int pos, int lowpos, int lg) {
    insert_upto(pos);
    Match best{lg, 0, 0};
    const uint32_t pat = s.read4(pos);
    const int e = head[hash4(pat)];
    const int lowest = max(pos - kWindow, 0);
    const int lookback = pos - lowpos;
    if (e == kEmpty || e < lowest || e >= pos) return best;
    const bool pa = depth > 128;
    int c = e;
    int rep = 0;  // 0 untested, 1 aperiodic, 2 periodic
    int spl = 0;  // source-side run length of a periodic pattern
    for (int tries = depth; tries > 0; --tries) {
      // score candidate c
      if (s.read16c(lowpos + best.len - 1) ==
              s.read16c(c - lookback + best.len - 1) &&
          s.read4(c) == pat && !(favor && pos - c < 8)) {
        int tot = kMinMatch + fwd_count(pos + kMinMatch, c + kMinMatch,
                                        matchlimit - (pos + kMinMatch));
        int bk = 0;
        if (lookback > 0) {
          const int maxb = min(lookback, c);
          while (bk < maxb && s.byte(pos - 1 - bk) == s.byte(c - 1 - bk)) ++bk;
        }
        tot += bk;
        if (tot > best.len) best = Match{tot, pos - c, bk};
      }
      // next candidate
      const int dlt = chain[c];
      bool applies = false;
      int cand = c - 1;
      if (pa && c > 0 && dlt == 1) {
        if (rep == 0) {
          const bool periodic = (pat & 0xFFFFu) == (pat >> 16) &&
                                (pat & 255u) == (pat >> 24);
          if (periodic)
            spl = count_pat_fwd(pos + kMinMatch, pat, matchlimit) + kMinMatch;
          rep = periodic ? 2 : 1;
        }
        applies = rep == 2 && cand >= lowest && s.read4(max(cand, 0)) == pat;
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
            if (pos - c_nf > kWindow)
              brk = true;
            else
              best = Match{max_ml, pos - c_nf, 0};
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

__global__ void __launch_bounds__(kThreads)
encode_hc_kernel(const uint8_t* __restrict__ src, const int* __restrict__ lens,
                 uint8_t* __restrict__ out, int* __restrict__ csizes,
                 int* __restrict__ trailing, int cap_n, int out_w, int depth,
                 int favor) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* z = reinterpret_cast<uint4*>(smem);
  const uint4 empty = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int i = threadIdx.x; i < kHeads * 2 / 16; i += blockDim.x) z[i] = empty;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), cap_n);
  const int mflimit = n - kMfLimit;
  Parser ps{Source{src + static_cast<size_t>(b) * cap_n, cap_n},
            reinterpret_cast<uint16_t*>(smem),
            reinterpret_cast<uint16_t*>(smem) + kHeads,
            n - kLastLiterals,
            depth,
            favor != 0,
            0};
  const Source& s = ps.s;
  Sink o{out + static_cast<size_t>(b) * out_w, 0, out_w};

  // m1 at ip is the current match (m0 at s0 its saved copy), m2 at s2 the
  // overlapping second, m3 at s3 the third
  int state = 0;
  int ip = 0, anchor = 0;
  int s0 = 0, s2 = 0;
  Match m1{0, 0, 0}, m0{0, 0, 0}, m2{0, 0, 0};
  while (true) {
    if (state == 0) {  // scan for a first match at ip
      if (ip > mflimit) break;
      const Match m = ps.lazy_search(ip, ip, kMinMatch - 1);
      if (m.len >= kMinMatch && m.off > 0) {
        m1 = m;
        m0 = m;
        s0 = ip;
        state = 1;
      } else {
        ++ip;
      }
    } else if (state == 1) {  // Search2: a wider overlapping match
      const bool can2 = ip + m1.len <= mflimit;
      const int probe = ip + m1.len - 2;
      m2 = can2 ? ps.lazy_search(probe, ip, m1.len) : Match{m1.len, 0, 0};
      s2 = probe - m2.back;
      if (!(can2 && m2.len > m1.len && m2.off > 0)) {
        o.sequence(s, anchor, ip, m1.off, m1.len);  // commit m1
        ip += m1.len;
        anchor = ip;
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
      const bool can3 = s2 + m2.len <= mflimit;
      const int probe3 = s2 + m2.len - 3;
      const Match m3 =
          can3 ? ps.lazy_search(probe3, s2, m2.len) : Match{m2.len, 0, 0};
      const int s3 = probe3 - m3.back;
      if (!(can3 && m3.len > m2.len && m3.off > 0)) {
        // no better third: m1 (cut at s2), then m2
        if (s2 < ip + m1.len) m1.len = s2 - ip;
        o.sequence(s, anchor, ip, m1.off, m1.len);
        o.sequence(s, ip + m1.len, s2, m2.off, m2.len);
        ip = anchor = s2 + m2.len;
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
          o.sequence(s, anchor, ip, m1.off, m1.len);
          anchor = ip + m1.len;
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
        o.sequence(s, anchor, ip, m1.off, m1.len);
        anchor = ip + m1.len;
        ip = s2;
        m1 = m2;
        s2 = s3;
        m2 = m3;
      }
    }
  }
  // the final literal run
  const int litlen = max(n - anchor, 0);
  o.put(min(litlen, 15) << 4);
  if (litlen >= 15) o.len(litlen - 15);
  o.literals(s, anchor, litlen);
  csizes[b] = o.op;
  trailing[b] = litlen;
}

}  // namespace

// HC-encode B blocks at chain depth `depth`; returns the launch's
// cudaError_t (0 on success).
extern "C" int lz4t_encode_hc(const void* src, const void* lens, void* out,
                              void* csizes, void* trailing, int B, int cap_n,
                              int out_w, int depth, int favor, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      encode_hc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_hc_kernel<<<B, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(lens),
      static_cast<uint8_t*>(out), static_cast<int*>(csizes),
      static_cast<int*>(trailing), cap_n, out_w, depth, favor);
  return static_cast<int>(cudaGetLastError());
}
