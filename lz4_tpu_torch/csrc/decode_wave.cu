// B3: wave-arena decoder, one wave-split stream per warp.
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
// prints that byte bound for the main path), but the parse of a stream is
// a serial chain of dependent loads, so latency bounds it and the
// parallelism is across streams.
//
// What the design does about that: one warp per stream, so a batch puts
// hundreds of independent parses in flight. The TPU kernel's 128-lane
// interleave, one-hot selects, 2 KB near window and far escape existed
// because per-lane gathers are unsafe on the TPU; here every lane of the
// warp runs the parse in lockstep (one address for the whole warp is one
// transaction) and the copies are split across the lanes, with ordinary
// indexed loads for the match sources. A match of any offset copies in
// parallel: byte i is byte (i mod offset) of the `offset` bytes before it
// when it overlaps itself. __syncwarp() orders each copy's writes before
// the next copy's reads. The history is a separate input row (round t-1's
// output in linked mode), so there is no ring to guard.
//
// The splitter validates the stream, so the kernel runs no format checks;
// it still bounds every read to the piece's own arena slot and every
// write to the piece's own output bytes, so a garbage arena can never
// touch memory outside its rows (its output is then unspecified).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWaveOut = 1024;
constexpr int kWaveCap = 1088;
constexpr int kHist = 65536;

__global__ void __launch_bounds__(32)
decode_wave_kernel(const uint8_t* __restrict__ arenas,
                   const int* __restrict__ out_lens,
                   const uint8_t* __restrict__ hist, uint8_t* out, int np) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* in = arenas + static_cast<size_t>(b) * np * kWaveCap;
  const uint8_t* h = hist ? hist + static_cast<size_t>(b) * kHist : nullptr;
  uint8_t* dst = out + static_cast<size_t>(b) * np * kWaveOut;
  const int n_out = min(max(out_lens[b], 0), np * kWaveOut);
  const int pieces = (n_out + kWaveOut - 1) / kWaveOut;

  for (int k = 0; k < pieces; ++k) {
    int c = k * kWaveCap;
    const int c_end = c + kWaveCap;
    int o = k * kWaveOut;
    const int o_end = min(o + kWaveOut, n_out);
    auto rd = [&](int q) -> int { return q < c_end ? __ldg(in + q) : 0; };
    while (o < o_end && c < c_end) {
      const int tok = rd(c++);
      int lit = tok >> 4;
      const int mn = tok & 15;
      if (lit == 15) lit += rd(c++);
      for (int i = lane; i < lit; i += 32)
        if (o + i < o_end) dst[o + i] = static_cast<uint8_t>(rd(c + i));
      c += lit;
      o += lit;
      __syncwarp();
      if (mn == 0) continue;  // literal-only sequence: no offset bytes
      const int off = rd(c) | (rd(c + 1) << 8);
      c += 2;
      int mlen = mn;
      if (mn == 15) mlen += rd(c++);
      if (off > 0) {
        const int base = o - off;
        const bool periodic = off < mlen;
        for (int i = lane; i < mlen; i += 32) {
          if (o + i >= o_end) break;
          const int x = base + (periodic ? i % off : i);
          int v = 0;
          if (x >= 0)
            v = dst[x];
          else if (h != nullptr && x >= -kHist)
            v = __ldg(h + kHist + x);
          dst[o + i] = static_cast<uint8_t>(v);
        }
      }
      o += mlen;
      __syncwarp();
    }
  }
}

}  // namespace

// Decode B wave-split streams of np pieces each; hist is null or a
// uint8[B, 65536] history row per stream (right-aligned, position -1 at
// its last byte). Returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_decode_wave(const void* arenas, const void* out_lens,
                                const void* hist, void* out, int B, int np,
                                void* stream) {
  decode_wave_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(arenas), static_cast<const int*>(out_lens),
      static_cast<const uint8_t*>(hist), static_cast<uint8_t*>(out), np);
  return static_cast<int>(cudaGetLastError());
}
