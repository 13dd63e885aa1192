"""Streaming frame compression, the frameCompress.c analog: the
incremental LZ4F-style API (begin/update/end and the push decompressor)
over arbitrary chunk sizes, with block and content checksums, on the
default backend (the GPU unless `backend` names another).

    python -m lz4_tpu_torch.examples.frame_compress
"""
import io

from lz4_tpu_torch.frame.format import FrameInfo, Preferences
from lz4_tpu_torch.frame.reader import FrameDecompressor
from lz4_tpu_torch.frame.writer import FrameCompressor
from lz4_tpu_torch.utils.datagen import mixed_corpus

CHUNK = 16 * 1024


def main(backend=None):
    src = mixed_corpus(1024 * 1024, seed=5)
    prefs = Preferences(frame_info=FrameInfo(
        block_size_id=5, block_checksum=True, content_checksum=True))

    comp = FrameCompressor(prefs, level=1, backend=backend)
    out = io.BytesIO()
    out.write(comp.begin())
    for i in range(0, len(src), CHUNK):
        out.write(comp.update(src[i: i + CHUNK]))
    out.write(comp.end())
    blob = out.getvalue()

    dec = FrameDecompressor(backend=backend)
    back = io.BytesIO()
    for i in range(0, len(blob), 777):         # any push granularity
        piece = blob[i: i + 777]
        while piece and not dec.frame_done:    # a feed may stop short
            out_bytes, consumed = dec.feed(piece)
            back.write(out_bytes)
            piece = piece[consumed:]
    assert dec.frame_done and back.getvalue() == src
    print(f"frame: {len(src)} -> {len(blob)} bytes "
          f"({100.0 * len(blob) / len(src):.1f}%), "
          "block checksums verified: OK")


if __name__ == "__main__":
    main()
