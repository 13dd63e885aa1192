// B1: serial greedy LZ4 fast-tier block encoder, one LZ4 block per CTA.
//
// Replaces: lz4_tpu/block/encode_pallas.py : _encode_kernel (driven by
// _encode_pallas_raw and encode_blocks_pallas). Same parse, step for step:
// Knuth hash of 4 bytes into a 2^16-entry table, two scan positions per
// step with the reference skip rule (gap one srch>>6, gap two
// (srch+1)>>6), back-extension down to the anchor and the history start,
// forward count up to matchlimit, tail insert at p+ml-2, history
// pre-insert at dict_stride before the first scan, and the max_dist cap.
//
// What bounds it on the card: not bytes. The function moves each source
// byte in once and each compressed byte out once (tens of microseconds
// for the 48 MB main path at 3.35 TB/s); the parse is a serial chain of
// dependent loads per block, so latency bounds it, and the only
// parallelism is across blocks.
//
// What the design does about that: one CTA per block, and the hash table
// lives in shared memory so each probe is a shared-memory access, not a
// trip to device memory. The TPU table is 2^16 x int32 = 256 KB, more
// than the 227 KB a CTA may have; here an entry is 17 bits (a position
// below 2 * 65536 in dict mode): a uint16 array of low halves (128 KB)
// plus a bit array of high bits (8 KB). The CTA's threads clear it, then
// thread 0 runs the parse. The table is fresh for every block, so unlike
// the TPU kernel's 6-bit grid-step tag nothing leaks from block b-64. A
// zeroed entry reads as position 0, which the TPU table also holds for
// its first block; a probe can only validate against position 0 in the
// slot that position 0 itself was inserted into, so it never changes a
// result. One CTA fills an SM (136 KB of shared memory): 132 blocks run
// at a time. Reads past the source row read 0 and nothing is written past
// the output row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashLog = 16;
constexpr int kTableSize = 1 << kHashLog;
constexpr uint32_t kHashMul = 2654435761u;
constexpr int kSkipTrigger = 6;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;
constexpr int kDictCap = 65536;
constexpr int kThreads = 128;
constexpr int kSmemBytes =
    kTableSize * sizeof(uint16_t) + (kTableSize / 32) * sizeof(uint32_t);

// The block's bytes in logical coordinates: [d0 history bytes | block].
struct Source {
  const uint8_t* src;   // the block's row, cap_n bytes
  const uint8_t* dict;  // its right-aligned 64 KB history (dict mode)
  int d0;               // 65536 in dict mode, else 0
  int cap_n;

  __device__ __forceinline__ uint32_t byte(int q) const {
    if (q < d0) return __ldg(dict + q);
    const int i = q - d0;
    return i < cap_n ? __ldg(src + i) : 0u;
  }
  __device__ __forceinline__ uint32_t read4(int q) const {
    return byte(q) | (byte(q + 1) << 8) | (byte(q + 2) << 16) |
           (byte(q + 3) << 24);
  }
};

// 17-bit positions: low halves in a uint16 array, bit 16 in a bit array.
struct Table {
  uint16_t* lo;
  uint32_t* hi;

  __device__ __forceinline__ int get(uint32_t h) const {
    return lo[h] | (((hi[h >> 5] >> (h & 31)) & 1u) << 16);
  }
  __device__ __forceinline__ void put(uint32_t h, int q) {
    lo[h] = static_cast<uint16_t>(q);
    const uint32_t m = 1u << (h & 31);
    const uint32_t w = hi[h >> 5];
    hi[h >> 5] = (q & 0x10000) ? (w | m) : (w & ~m);
  }
};

__device__ __forceinline__ uint32_t hash4(uint32_t seq) {
  return (seq * kHashMul) >> (32 - kHashLog);
}

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
};

// Scan from p to the next validated match (insert + probe + skip).
// On a hit, p and cand are the match position and its candidate.
__device__ __forceinline__ bool scan(const Source& s, Table& tab, int& p,
                                     int& cand, int srch, int low,
                                     int mflimit, int matchlimit,
                                     int max_dist) {
  int sp = p;
  while (sp <= mflimit) {
    const int sp1 = sp + (srch >> kSkipTrigger);
    // the speculative position's memory ops are clamped to matchlimit
    const int sp1c = min(sp1, matchlimit);
    const uint32_t seq0 = s.read4(sp);
    const uint32_t h0 = hash4(seq0);
    const int e0 = tab.get(h0);
    tab.put(h0, sp);
    if (e0 < sp && e0 >= low && sp - e0 <= max_dist && s.read4(e0) == seq0) {
      p = sp;   // on a hit at sp the entry at sp1 stays as it was
      cand = e0;
      return true;
    }
    const uint32_t seq1 = s.read4(sp1c);
    const uint32_t h1 = hash4(seq1);
    const int e1 = tab.get(h1);
    tab.put(h1, sp1c);
    if (sp1 <= mflimit && e1 < sp1 && e1 >= low && sp1 - e1 <= max_dist &&
        s.read4(e1) == seq1) {
      p = sp1;
      cand = e1;
      return true;
    }
    sp = sp1 + ((srch + 1) >> kSkipTrigger);
    srch += 2;
  }
  p = sp;
  return false;
}

__device__ __forceinline__ int fwd_count(const Source& s, int q1, int q2,
                                         int maxn) {
  int c = 0;
  while (c + 4 <= maxn && s.read4(q1 + c) == s.read4(q2 + c)) c += 4;
  while (c < maxn && s.byte(q1 + c) == s.byte(q2 + c)) ++c;
  return c;
}

__global__ void __launch_bounds__(kThreads)
encode_serial_kernel(const uint8_t* __restrict__ src,
                     const int* __restrict__ lens,
                     const uint8_t* __restrict__ dict,
                     const int* __restrict__ dict_lens,
                     uint8_t* __restrict__ out, int* __restrict__ csizes,
                     int* __restrict__ trailing, int cap_n, int out_w,
                     int has_dict, int accel, int dict_stride,
                     int max_dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < kSmemBytes / 16; i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int b = blockIdx.x;
  Table tab{reinterpret_cast<uint16_t*>(smem),
            reinterpret_cast<uint32_t*>(smem + kTableSize * sizeof(uint16_t))};
  const int d0 = has_dict ? kDictCap : 0;
  const Source s{src + static_cast<size_t>(b) * cap_n,
                 has_dict ? dict + static_cast<size_t>(b) * kDictCap : nullptr,
                 d0, cap_n};
  const int n = min(max(lens[b], 0), cap_n);
  const int low = has_dict ? d0 - min(dict_lens[b], d0) : 0;
  const int mflimit = d0 + n - kMfLimit;        // last match start
  const int matchlimit = d0 + n - kLastLiterals;  // match bytes end here
  const int accel0 = accel << kSkipTrigger;
  Sink o{out + static_cast<size_t>(b) * out_w, 0, out_w};

  // history pre-insert (dict/linked mode), before the first scan
  for (int q = low; q < d0; q += dict_stride) tab.put(hash4(s.read4(q)), q);

  int anchor = d0;
  int p = d0;
  int cand = 0;
  bool hit = scan(s, tab, p, cand, accel0, low, mflimit, matchlimit,
                  max_dist);
  while (hit) {
    int p2 = p;
    int c2 = cand;
    while (p2 > anchor && c2 > low && s.byte(p2 - 1) == s.byte(c2 - 1)) {
      --p2;
      --c2;
    }
    const int offset = p2 - c2;
    const int ml = (p - p2) + kMinMatch +
                   fwd_count(s, p + kMinMatch, cand + kMinMatch,
                             matchlimit - (p + kMinMatch));
    const int litlen = p2 - anchor;
    const int m4 = ml - kMinMatch;
    o.put((min(litlen, 15) << 4) | min(m4, 15));
    if (litlen >= 15) o.len(litlen - 15);
    o.literals(s, anchor, litlen);
    o.put(offset & 255);
    o.put(offset >> 8);
    if (m4 >= 15) o.len(m4 - 15);
    const int t2 = p2 + ml - 2;  // tail insert
    tab.put(hash4(s.read4(t2)), t2);
    anchor = p2 + ml;
    p = anchor;
    hit = scan(s, tab, p, cand, accel0, low, mflimit, matchlimit, max_dist);
  }
  // the final literal run
  const int litlen = max(d0 + n - anchor, 0);
  o.put(min(litlen, 15) << 4);
  if (litlen >= 15) o.len(litlen - 15);
  o.literals(s, anchor, litlen);
  csizes[b] = o.op;
  trailing[b] = litlen;
}

}  // namespace

// Encode B blocks; returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_encode_serial(const void* src, const void* lens,
                                  const void* dict, const void* dict_lens,
                                  void* out, void* csizes, void* trailing,
                                  int B, int cap_n, int out_w, int has_dict,
                                  int accel, int dict_stride, int max_dist,
                                  void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      encode_serial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_serial_kernel<<<B, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(dict), static_cast<const int*>(dict_lens),
      static_cast<uint8_t*>(out), static_cast<int*>(csizes),
      static_cast<int*>(trailing), cap_n, out_w, has_dict, accel,
      dict_stride, max_dist);
  return static_cast<int>(cudaGetLastError());
}
