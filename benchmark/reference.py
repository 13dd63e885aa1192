"""The benchmark's plain LZ4 block decoder: the reference that decides
`correct`.

Written from the block format alone (lz4 doc/lz4_Block_format.md), in
plain Python over bytes. It imports nothing of the program under test.
It is strict: it holds a stream to every rule of the format that an
independent block must keep, and raises `FormatError` on the first it
breaks.

- A sequence is a token (literal length in the high nibble, match length
  less 4 in the low one, 15 meaning that bytes of 255 and one last byte
  extend it), the literals, a 2-byte little-endian offset and the match.
- An offset is never 0 and never reaches before the block's first byte:
  the blocks are independent, with no dictionary.
- The last sequence holds literals only, and the stream ends with it.
- The last 5 bytes of a block are literals, and the last match starts at
  least 12 bytes before the block's end.
"""
from __future__ import annotations

MINMATCH = 4
LASTLITERALS = 5
MFLIMIT = 12


class FormatError(ValueError):
    """A stream that is not the independent LZ4 block it should be."""


def decode_block(stream: bytes, n_out: int) -> bytes:
    """The n_out bytes that `stream` encodes. Raises FormatError where the
    stream breaks a rule of the format or decodes to another length."""
    src = bytes(stream)
    n = len(src)
    out = bytearray()
    i = 0
    last_match_start = -1
    last_match_end = 0
    while True:
        if i >= n:
            raise FormatError("stream ends inside a sequence")
        tok = src[i]
        i += 1
        lit = tok >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise FormatError("stream ends in a literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise FormatError("literals run past the stream")
        out += src[i: i + lit]
        i += lit
        if i == n:
            break                   # the last sequence: literals only
        if i + 2 > n:
            raise FormatError("stream ends in an offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = tok & 15
        if ml == 15:
            while True:
                if i >= n:
                    raise FormatError("stream ends in a match length")
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += MINMATCH
        pos = len(out)
        if off == 0 or off > pos:
            raise FormatError(f"offset {off} at output byte {pos}")
        if pos + ml > n_out:
            raise FormatError("output longer than the block")
        start = pos - off
        if off >= ml:
            out += out[start: start + ml]
        else:                       # the match overlaps its own output
            pat = bytes(out[start:])
            out += (pat * (ml // off + 1))[:ml]
        last_match_start = pos
        last_match_end = pos + ml
    if len(out) != n_out:
        raise FormatError(f"decodes to {len(out)} bytes, not {n_out}")
    if last_match_start >= 0 and (
            last_match_end > n_out - LASTLITERALS
            or last_match_start > n_out - MFLIMIT):
        raise FormatError("a match too near the block's end")
    return bytes(out)
