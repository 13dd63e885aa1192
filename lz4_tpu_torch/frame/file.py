"""File-object wrappers over the frame layer (the port's own copy of
lz4_tpu/frame/file.py): the lib/lz4file.c analog (LZ4F_readOpen/read/
readClose, lz4file.c:73-200; LZ4F_writeOpen/write/writeClose,
lz4file.c:217-340), shaped as a pythonic file object and an `open()`
helper instead of a C handle API.
"""
from __future__ import annotations

import io

from lz4_tpu_torch.frame.format import Preferences
from lz4_tpu_torch.frame.reader import FrameDecompressor
from lz4_tpu_torch.frame.writer import CDict, FrameCompressor

_READ_CHUNK = 1 << 20


class Lz4FrameReader(io.RawIOBase):
    """Streaming reader: yields decompressed bytes from a .lz4 file
    object (multi-frame aware)."""

    def __init__(self, fileobj, *, backend=None, dict_content=None):
        self._f = fileobj
        self._backend = backend
        self._dict = dict_content
        self._dec = FrameDecompressor(backend=backend,
                                      dict_content=dict_content)
        self._buf = bytearray()
        self._pending = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            if not self._pending:
                self._pending = self._f.read(_READ_CHUNK)
                if not self._pending:
                    if not self._dec.frame_done and \
                            not self._dec.at_legacy_eof_boundary and \
                            self._dec.next_hint and self._dec._info is not None:
                        raise IOError("truncated lz4 stream")
                    self._eof = True
                    return
            out, consumed = self._dec.feed(self._pending)
            self._pending = self._pending[consumed:]
            self._buf += out
            if self._dec.frame_done:
                # multi-frame: splice back any legacy lookahead and start
                # a fresh decoder for the next concatenated frame
                self._pending = self._dec.legacy_lookahead + self._pending
                self._dec = FrameDecompressor(
                    backend=self._backend, dict_content=self._dict)

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            chunks = []
            while True:
                self._fill()
                if not self._buf:
                    return b"".join(chunks)
                chunks.append(bytes(self._buf))
                self._buf.clear()
        self._fill()
        out = bytes(self._buf[:size])
        del self._buf[:size]
        return out

    def close(self) -> None:
        super().close()


class Lz4FrameWriter(io.RawIOBase):
    """Streaming writer: compresses written bytes into a .lz4 frame."""

    def __init__(self, fileobj, *, prefs: Preferences | None = None,
                 level: int = 0, acceleration: int = 1,
                 cdict: CDict | None = None, backend=None):
        self._f = fileobj
        self._comp = FrameCompressor(prefs, level=level,
                                     acceleration=acceleration,
                                     cdict=cdict, backend=backend)
        self._f.write(self._comp.begin())
        self._ended = False

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._f.write(self._comp.update(bytes(data)))
        return len(data)

    def flush(self) -> None:
        self._f.write(self._comp.flush())
        if hasattr(self._f, "flush"):
            self._f.flush()

    def close(self) -> None:
        if not self._ended and not self.closed:
            self._f.write(self._comp.end())
            self._ended = True
        super().close()


def open_frame(path, mode: str = "rb", **kw):
    """open() analog for .lz4 files: modes 'rb' (decompress-on-read) and
    'wb' (compress-on-write)."""
    if mode == "rb":
        return Lz4FrameReader(open(path, "rb"), **kw)
    if mode == "wb":
        return Lz4FrameWriter(open(path, "wb"), **kw)
    raise ValueError(f"unsupported mode {mode!r}")
