"""A linked block joined with its history into one independent block, so
that the strict decoder of `reference.py` can judge it.

Plain Python over bytes; it imports nothing of the program under test.

A linked LZ4 block (lz4 doc/lz4_Block_format.md, lz4 doc/
lz4_Frame_format.md "Block Independence flag") is decoded with the bytes
of its stream before it in the output buffer: a match may reach back
into that history. `join(history, stream)` writes the history as a
leading literal run, merged into the stream's first sequence, and leaves
every other byte of the stream as it is. The joined stream is an
independent block of `history + block`, and `reference.decode_block`
holds it to every rule it holds an independent block to:

- a match of the stream that reaches into the history lands, in the
  joined block, on the same history byte, now inside the block: the
  offset is the same number, measured from the same place;
- a match that reaches before the history's first byte reaches before
  the joined block's first byte, and stays an error; so does offset 0;
- the joined block ends where the stream's block ends, with the same
  last sequence, so "the last 5 bytes are literals" and "the last match
  starts at least 12 bytes before the end" hold of the join exactly
  when they hold of the stream;
- the join decodes to exactly `history + block`, and the stream to
  exactly `block`, or neither does.

A stream whose first sequence cannot be parsed (empty, or cut inside its
literal length or its literals) comes back as it is, so that the strict
decoder reports it.
"""
from __future__ import annotations


def _length_bytes(n: int) -> bytes:
    """The extension bytes of a length field whose nibble is 15: bytes of
    255 and one last byte, for n >= 15."""
    n -= 15
    return b"\xff" * (n // 255) + bytes([n % 255])


def join(history: bytes, stream: bytes) -> bytes:
    """The independent LZ4 block of `history + block`, where `stream` is
    the block's linked stream with `history` before it (module
    docstring); `stream` as it is where its first sequence cannot be
    parsed."""
    src = bytes(stream)
    hist = bytes(history)
    if not hist or not src:
        return src
    tok = src[0]
    i = 1
    lit = tok >> 4
    if lit == 15:
        while True:
            if i >= len(src):
                return src
            b = src[i]
            i += 1
            lit += b
            if b != 255:
                break
    if i + lit > len(src):
        return src
    lit2 = len(hist) + lit
    head = bytes([(min(lit2, 15) << 4) | (tok & 15)])
    if lit2 >= 15:
        head += _length_bytes(lit2)
    return head + hist + src[i:]
