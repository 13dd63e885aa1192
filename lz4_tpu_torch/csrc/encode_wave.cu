// B4: lockstep-tier match finder, one block per thread.
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
// 0.03 ms for the 768 x 64 KB main path at 3.35 TB/s), but each block's
// scan is a serial chain: position q's probe reads the entry that
// position q-1 may have written. Latency bounds it; the parallelism is
// across blocks.
//
// What the design does about that: one thread per block, its table of
// 2^hash_bits packed entries (4 KB at 10 bits) in shared memory, so the
// probe and insert are shared-memory round trips. The TPU kernel's
// one-hot table passes and 513-row near window existed because per-lane
// gathers are unsafe there; here both are ordinary indexed loads. Input
// words are read two at a time per 4 positions; reads past len or past
// the row read 0. The launch spreads the batch over the SMs: threads per
// CTA = ceil(B / SMs), as shared memory allows. Decisions go into a
// zeroed array, written only where a match ends.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kKnuth = 2654435761u;
constexpr int kMaxMlen = 16384;

struct Block {
  const uint8_t* in;
  int row_bytes;
  int len;
  __device__ uint32_t byte(int q) const {
    return (q >= 0 && q < len && q < row_bytes) ? __ldg(in + q) : 0u;
  }
  // 4 little-endian bytes at 4 * i
  __device__ uint32_t word(int i) const {
    const int q = 4 * i;
    if (q + 3 < len && q + 3 < row_bytes)
      return __ldg(reinterpret_cast<const uint32_t*>(in) + i);
    return byte(q) | (byte(q + 1) << 8) | (byte(q + 2) << 16) |
           (byte(q + 3) << 24);
  }
};

__global__ void encode_wave_kernel(const uint8_t* __restrict__ inp,
                                   const int* __restrict__ lens,
                                   const uint8_t* __restrict__ hist,
                                   const int* __restrict__ hlens,
                                   int* __restrict__ dec, int B, int n_rows,
                                   int wr, int max_dist, int hash_bits) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int hash_rows = 1 << hash_bits;
  const int shift = 32 - hash_bits;
  uint32_t* table = smem + threadIdx.x * hash_rows;
  for (int r = 0; r < hash_rows; ++r) table[r] = 0xFFFFFFFFu;

  const int row_bytes = n_rows * 4;
  const Block x{inp + static_cast<size_t>(b) * row_bytes, row_bytes,
                lens[b]};
  const bool linked = hist != nullptr;
  const uint8_t* hrow =
      linked ? hist + static_cast<size_t>(b) * wr * 4 : nullptr;
  const int hl = linked ? hlens[b] : 0;
  int* drow = dec + static_cast<size_t>(b) * n_rows;

  if (linked) {
    // warmup: seed the table from the history tail; its last row is
    // skipped (that 4-gram spans into the block)
    for (int hr = 0; hr < wr - 1; ++hr) {
      for (int sub = 0; sub < 4; ++sub) {
        const int p = -4 * wr + 4 * hr + sub;
        if (p < -hl) continue;
        const int j = 4 * hr + sub;
        const uint32_t h4 = hrow[j] | (hrow[j + 1] << 8) |
                            (hrow[j + 2] << 16) |
                            (static_cast<uint32_t>(hrow[j + 3]) << 24);
        const uint32_t hh = (h4 * kKnuth) >> shift;
        table[hh] = (table[hh] << 16) | (static_cast<uint32_t>(p) & 0xFFFFu);
      }
    }
  }

  // no match ends at or past len - 5, so the scan stops at len
  const int q_end = min(x.len, row_bytes);
  int mode = 0, cand = 0, a = 0;
  uint32_t w1 = x.word(0);
  for (int i = 0; 4 * i < q_end; ++i) {
    const uint32_t w0 = w1;
    w1 = x.word(i + 1);
    for (int sub = 0; sub < 4; ++sub) {
      const int q = 4 * i + sub;
      const uint32_t cur4 =
          sub == 0 ? w0 : (w0 >> (8 * sub)) | (w1 << (32 - 8 * sub));
      const uint32_t curb = cur4 & 255u;
      // 1. probe
      const uint32_t h = (cur4 * kKnuth) >> shift;
      const uint32_t ent = table[h];
      const int c1 = static_cast<int>(ent & 0xFFFFu);
      const int c2 = static_cast<int>(ent >> 16);
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
      // 2. insert
      if (q + 4 <= x.len) table[h] = (ent << 16) | static_cast<uint32_t>(q);
      // 3. start
      if (mode == 0 && (ok1 || ok2) && q <= x.len - 12) {
        cand = cnd;
        a = q;
        mode = 1;
      }
      // 4-5. verify, extend or end
      if (mode == 1) {
        const int src = cand + (q - a);
        const int hj = src + 4 * wr;  // history byte of a negative src
        const uint32_t mb = src >= 0 ? x.byte(src)
                            : (linked && hj >= 0) ? hrow[hj]
                                                  : 0u;
        const int mlen = q - a;
        const bool good =
            mb == curb && q < x.len - 5 && mlen < kMaxMlen + 3;
        if (!good) {
          if (mlen >= 4)
            drow[i] = (a - cand) | (sub << 16) |
                      static_cast<int>(static_cast<uint32_t>(mlen - 4) << 18);
          mode = 0;
        }
      }
    }
  }
}

}  // namespace

// Find matches in B blocks (input rows of n_rows * 4 bytes); hist is null
// or uint8[B, wr * 4] right-aligned history tails with hlens int32[B].
// dec must be zeroed int32[B, n_rows]. threads = blocks per CTA. Returns
// the launch's cudaError_t (0 on success).
extern "C" int lz4t_encode_wave(const void* inp, const void* lens,
                                const void* hist, const void* hlens,
                                void* dec, int B, int n_rows, int wr,
                                int max_dist, int hash_bits, int threads,
                                void* stream) {
  const size_t smem = static_cast<size_t>(threads) * (size_t{4} << hash_bits);
  cudaError_t e = cudaFuncSetAttribute(
      encode_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (B + threads - 1) / threads;
  encode_wave_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(inp), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(hist), static_cast<const int*>(hlens),
      static_cast<int*>(dec), B, n_rows, wr, max_dist, hash_bits);
  return static_cast<int>(cudaGetLastError());
}
