// B2: serial LZ4 block decoder, one LZ4 block per warp.
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
// never reaches its last sequence is an error; olen is 0 on error.
//
// What bounds it on the card: not bytes. The function reads each
// compressed byte once and writes each decoded byte once (tens of
// microseconds for the 48 MB main path at 3.35 TB/s), but the parse of a
// block is a serial chain of dependent loads, so latency bounds it and
// the parallelism is across blocks.
//
// What the design does about that: one warp per block, so a 64 KB block
// batch puts hundreds of independent parses in flight at once. All 32
// lanes run the parse in lockstep (a load of one address by the whole
// warp is one transaction), so nothing is broadcast; the copies are split
// across the lanes. A match of any offset, overlapping or not, copies in
// parallel: byte i of the match is byte (i mod offset) of the `offset`
// bytes before it, all of which were written before the copy starts.
// __syncwarp() orders each copy's writes before the next copy's reads.
// Reads at or past the input row read 0, and the checks above keep every
// write inside the output row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDictCap = 65536;
constexpr int kMinMatch = 4;

__global__ void __launch_bounds__(32)
decode_serial_kernel(const uint8_t* __restrict__ comp,
                     const int* __restrict__ comp_lens,
                     const uint8_t* __restrict__ dict,
                     const int* __restrict__ dict_lens, uint8_t* out,
                     int* __restrict__ olen, int* __restrict__ err_out,
                     int cap_in, int cap_out, int has_dict, int loose) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* in = comp + static_cast<size_t>(b) * cap_in;
  const uint8_t* hist =
      has_dict ? dict + static_cast<size_t>(b) * kDictCap : nullptr;
  uint8_t* dst = out + static_cast<size_t>(b) * cap_out;
  const long long d0 = has_dict ? kDictCap : 0;
  const long long M = comp_lens[b];
  const long long low = has_dict ? d0 - min(dict_lens[b], kDictCap) : 0;
  const long long ow = d0 + cap_out;  // end of the output window
  auto cb = [&](long long q) -> uint32_t {
    return (q >= 0 && q < cap_in) ? __ldg(in + q) : 0u;
  };

  long long p = 0;
  long long o = d0;
  bool err = M < 0;
  bool done = M < 0;
  while (p < M && !err && !done) {
    const uint32_t tok = cb(p);
    const int matnib = tok & 15;
    long long litlen = tok >> 4;
    long long q = p + 1;
    if (litlen == 15) {
      uint32_t v;
      do {
        v = cb(q++);
        litlen += v;
      } while (v == 255);
    }
    const long long lit_start = q;
    const long long lit_end = lit_start + litlen;
    const bool is_last = lit_end >= M;
    long long offset = 0;
    long long mext = 0;
    long long next_p = lit_end + 2;
    if (!is_last) {
      offset = cb(lit_end) | (cb(lit_end + 1) << 8);
      if (matnib == 15) {
        uint32_t v;
        do {
          v = cb(next_p++);
          mext += v;
        } while (v == 255);
      }
    }
    const long long mlen = kMinMatch + matnib + mext;

    bool serr = (is_last && lit_end != M) || (o + litlen > ow);
    if (!serr) {
      for (long long i = lane; i < litlen; i += 32)
        dst[o - d0 + i] = static_cast<uint8_t>(cb(lit_start + i));
    }
    __syncwarp();
    const long long o_mid = o + litlen;
    if (!is_last) {
      serr = serr || next_p > M || offset == 0 || (!loose && lit_end > M - 8);
    }
    bool do_match = !is_last && !serr;
    if (do_match) {
      serr = o_mid - offset < low || o_mid + mlen > ow ||
             (!loose && o_mid > ow - 12);
      do_match = !serr;
    }
    if (do_match) {
      const long long base = o_mid - offset;
      const bool periodic = offset < mlen;
      for (long long i = lane; i < mlen; i += 32) {
        const long long x = base + (periodic ? i % offset : i);
        dst[o_mid - d0 + i] = x < d0 ? __ldg(hist + x) : dst[x - d0];
      }
    }
    __syncwarp();
    o = do_match ? o_mid + mlen : (serr ? o : o_mid);
    done = is_last || serr;
    err = serr;
    p = next_p;
  }
  if (lane == 0) {
    const bool e = err || !done;  // truncated or endless stream
    olen[b] = e ? 0 : static_cast<int>(o - d0);
    err_out[b] = e ? 1 : 0;
  }
}

}  // namespace

// Decode B blocks; returns the launch's cudaError_t (0 on success).
extern "C" int lz4t_decode_serial(const void* comp, const void* comp_lens,
                                  const void* dict, const void* dict_lens,
                                  void* out, void* olen, void* err, int B,
                                  int cap_in, int cap_out, int has_dict,
                                  int loose, void* stream) {
  decode_serial_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int*>(comp_lens),
      static_cast<const uint8_t*>(dict), static_cast<const int*>(dict_lens),
      static_cast<uint8_t*>(out), static_cast<int*>(olen),
      static_cast<int*>(err), cap_in, cap_out, has_dict, loose);
  return static_cast<int>(cudaGetLastError());
}
