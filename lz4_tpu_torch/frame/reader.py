"""LZ4 frame decompression: one-shot and resumable streaming reader (the
port's own copy of lz4_tpu/frame/reader.py, driving the port's block
backend). On `HostBackend` the frame body goes through the C frame
walker (`native/framewalk.c`), one call per run of complete blocks; on
any other backend blocks are walked in Python and handed to the backend
in batches.

Behavioural parity targets (SURVEY.md §2 #11):
  * LZ4F_decompress's 14-stage push state machine (lz4frame.c:1248-2118) —
    re-designed as a host-side resumable cursor: input may arrive at any
    byte granularity; whole blocks are handed to the (batchable) block
    backend; `next_hint` mirrors the "next srcSize hint" return.
  * LZ4F_getFrameInfo (lz4frame.c:1444-1520).
  * Multi-frame concatenation + skippable frames + legacy frames
    (this module decodes each frame type).
Validates header checksum, optional block checksums and the content
checksum; maintains the 64 KB history window for linked blocks.
"""
from __future__ import annotations

import struct

from lz4_tpu_torch.block.backend import (BlockBackend, BlockDecodeError,
                                         HostBackend, default_backend)
from lz4_tpu_torch.constants import (
    BLOCK_UNCOMPRESSED_FLAG,
    LEGACY_BLOCKSIZE,
    LEGACY_MAGIC,
    LZ4_DISTANCE_MAX,
    LZ4F_MAGIC,
    LZ4F_MAGIC_SKIPPABLE_MASK,
    LZ4F_MAGIC_SKIPPABLE_START,
)
from lz4_tpu_torch.frame.format import FrameError, FrameInfo, parse_frame_header
from lz4_tpu_torch.xxh32 import XXH32State, xxh32


def get_frame_info(data: bytes) -> FrameInfo:
    info, _ = parse_frame_header(bytes(data))
    return info


class FrameDecompressor:
    """Resumable push decoder for one frame (plus `frame_done` signaling so
    callers can loop over concatenated frames)."""

    # stages
    _HEADER = "header"
    _BLOCK_HEADER = "block_header"
    _BLOCK_DATA = "block_data"
    _BLOCK_CHECKSUM = "block_checksum"
    _CONTENT_CHECKSUM = "content_checksum"
    _SKIP_BODY = "skip_body"
    _LEGACY_BLOCK_HEADER = "legacy_block_header"
    _LEGACY_BLOCK_DATA = "legacy_block_data"
    _PUMP = "pump"            # the C frame walker owns the frame body
    _DONE = "done"

    # The C frame walker serves HostBackend frames; False keeps the Python
    # walk (the counterpart of the JAX package's LZ4_TPU_FRAME_PUMP=0).
    frame_pump = True

    def __init__(self, *, backend: BlockBackend | None = None,
                 dict_content: bytes | None = None,
                 verify_checksums: bool = True,
                 zero_copy: bool = False):
        self.backend = backend or default_backend()
        self._dict = bytes(dict_content or b"")
        self.verify_checksums = verify_checksums
        # zero_copy=True lets feed() return a memoryview over the pump's
        # per-call arena, which nothing writes again (the I/O engine opts
        # in); the default returns bytes.
        self.zero_copy = zero_copy
        self.reset()

    def reset(self) -> None:
        self._stage = self._HEADER
        self._buf = bytearray()
        self._need = 5
        self._info: FrameInfo | None = None
        self._history = bytearray(self._dict[-LZ4_DISTANCE_MAX:])
        self._xxh = XXH32State(0)
        self._total_out = 0
        self._cur_block_size = 0
        self._cur_block_raw = False
        self._pending_payload: bytes | None = None
        self._batch: list[tuple[bool, bytes]] = []

    @property
    def frame_info(self) -> FrameInfo | None:
        return self._info

    @property
    def frame_done(self) -> bool:
        return self._stage == self._DONE

    @property
    def next_hint(self) -> int:
        """How many more input bytes the decoder can consume right now —
        the analog of LZ4F_decompress's return hint."""
        if self._stage == self._DONE:
            return 0
        return max(1, self._need - len(self._buf))

    def feed(self, data: bytes) -> tuple[bytes, int]:
        """Push bytes in; returns (decoded_output, consumed). Bytes beyond
        the end of the current frame are not consumed. With the pump a
        feed can also stop early, after completing a block word from its
        buffer (as in the JAX reader): feed the rest again.

        Independent-mode blocks that arrive complete within one feed()
        are decoded as ONE batch (the device grid is the worker pool);
        linked blocks decode serially since each needs the previous
        block's output as history."""
        data = bytes(data)
        out = bytearray()
        fast = None        # the pump's one buffer, handed on uncopied
        consumed = 0
        while self._stage != self._DONE:
            if self._stage == self._PUMP:
                pieces, used = self._pump_feed(data, consumed)
                consumed += used
                if pieces:
                    if not out and fast is None and len(pieces) == 1:
                        fast = pieces[0]
                    else:
                        if fast is not None:
                            out += fast
                            fast = None
                        for p in pieces:
                            out += p
                if self._stage == self._PUMP:
                    break          # everything consumable is consumed
                continue
            if not self._buf and len(data) - consumed >= self._need:
                # fast path: the whole stage payload is available in
                # the input — one extraction, no bytearray round trip
                chunk = bytes(data[consumed: consumed + self._need])
                consumed += self._need
                out += self._step(chunk)
                continue
            if len(self._buf) < self._need:
                take = min(len(data) - consumed,
                           self._need - len(self._buf))
                if take <= 0 and len(self._buf) < self._need:
                    break
                self._buf += data[consumed: consumed + take]
                consumed += take
                if len(self._buf) < self._need:
                    break
            chunk = bytes(self._buf[: self._need])
            del self._buf[: self._need]
            out += self._step(chunk)
        out_flush = self._flush_batch()
        if out_flush:
            if fast is not None:
                out += fast
                fast = None
            out += out_flush
        if fast is not None:
            return (fast if self.zero_copy else bytes(fast)), consumed
        return bytes(out), consumed

    # ------------------------------------------------------------- stages
    def _step(self, chunk: bytes) -> bytes:
        stage = self._stage
        if stage == self._HEADER:
            return self._on_header(chunk)
        if stage == self._BLOCK_HEADER:
            return self._on_block_header(chunk)
        if stage == self._BLOCK_DATA:
            return self._on_block_data(chunk)
        if stage == self._BLOCK_CHECKSUM:
            return self._on_block_checksum(chunk)
        if stage == self._CONTENT_CHECKSUM:
            return self._on_content_checksum(chunk)
        if stage == self._SKIP_BODY:
            self._stage = self._DONE
            return b""
        if stage == self._LEGACY_BLOCK_HEADER:
            return self._on_legacy_block_header(chunk)
        if stage == self._LEGACY_BLOCK_DATA:
            return self._on_legacy_block_data(chunk)
        raise AssertionError(stage)

    def _on_header(self, chunk: bytes) -> bytes:
        from lz4_tpu_torch.frame.format import header_size
        need = header_size(chunk)
        if len(chunk) < need:
            self._buf[:0] = chunk      # put back, wait for the full header
            self._need = need
            return b""
        info, used = parse_frame_header(chunk)
        if used < len(chunk):          # e.g. 4-byte legacy magic from a
            self._buf[:0] = chunk[used:]   # 5-byte minimum read
        self._info = info
        if info.frame_type == "skippable":
            if info.content_size:
                self._stage = self._SKIP_BODY
                self._need = info.content_size
            else:
                self._stage = self._DONE
            return b""
        if info.frame_type == "legacy":
            self._stage = self._LEGACY_BLOCK_HEADER
            self._need = 4
            return b""
        self._stage = self._BLOCK_HEADER
        self._need = 4
        # the C frame walker (native/framewalk.c, the decode loop of the
        # reference's lz4io.c:1942-2203): on the host C tier the whole
        # frame body (block words, checksums, linked history, content
        # XXH32) goes through one C call per run of complete blocks
        bc = self._pump_eligible()
        if bc is not None:
            self._pump_bc = bc
            self._pump_state = bc.frame_state_new(
                block_checksum=info.block_checksum,
                independent=info.block_independent,
                content_checksum=info.content_checksum,
                verify=self.verify_checksums,
                block_max=info.block_max_size,
                dict_content=self._dict)
            self._stage = self._PUMP
        return b""

    def _on_block_header(self, chunk: bytes) -> bytes:
        word = struct.unpack("<I", chunk)[0]
        if word == 0:   # endmark
            out = self._flush_batch()   # checksum/size checks need order
            if self._info.content_checksum:
                self._stage = self._CONTENT_CHECKSUM
                self._need = 4
            else:
                self._finish()
            return out
        self._cur_block_raw = bool(word & BLOCK_UNCOMPRESSED_FLAG)
        size = word & ~BLOCK_UNCOMPRESSED_FLAG
        # neither stored nor compressed blocks may exceed blockMaxSize
        # (a compressed block larger than the raw data is stored raw)
        if size > self._info.block_max_size:
            raise FrameError("maxBlockSize_invalid", f"block size {size}")
        self._cur_block_size = size
        self._stage = self._BLOCK_DATA
        self._need = size
        return b""

    def _on_block_data(self, chunk: bytes) -> bytes:
        if self._info.block_checksum:
            self._pending_payload = chunk
            self._stage = self._BLOCK_CHECKSUM
            self._need = 4
            return b""
        return self._decode_block(chunk)

    def _on_block_checksum(self, chunk: bytes) -> bytes:
        want = struct.unpack("<I", chunk)[0]
        payload = self._pending_payload
        self._pending_payload = None
        if self.verify_checksums and xxh32(payload, 0) != want:
            raise FrameError("blockChecksum_invalid")
        return self._decode_block(payload)

    def _decode_block(self, payload: bytes) -> bytes:
        self._stage = self._BLOCK_HEADER
        self._need = 4
        if self._info.block_independent and not self._dict:
            # defer: batch with neighbouring blocks (flushed per feed())
            self._batch.append((self._cur_block_raw, payload))
            return b""
        if self._cur_block_raw:
            decoded = payload
        else:
            prefix = bytes(self._history) if self._history else None
            decoded = self.backend.decompress_batch(
                [payload], [self._info.block_max_size],
                dict_prefixes=[prefix])[0]
        self._account(decoded)
        return decoded

    def _account(self, decoded: bytes) -> None:
        if not self._info.block_independent:
            self._history += decoded
            if len(self._history) > LZ4_DISTANCE_MAX:
                del self._history[: len(self._history) - LZ4_DISTANCE_MAX]
        if self._info.content_checksum:
            self._xxh.update(decoded)
        self._total_out += len(decoded)

    def _flush_batch(self) -> bytes:
        """Decode all deferred independent blocks in one backend call."""
        if not self._batch:
            return b""
        batch = self._batch
        self._batch = []
        comp = [p for raw, p in batch if not raw]
        decoded_iter = iter(self.backend.decompress_batch(
            comp, [self._info.block_max_size] * len(comp))) if comp \
            else iter(())
        out = bytearray()
        for raw, p in batch:
            d = p if raw else next(decoded_iter)
            self._account(d)
            out += d
        return bytes(out)

    # ------------------------------------------------------------ the pump
    def _pump_eligible(self):
        """The C block codec facade when the frame walker should own this
        frame's body: `frame_pump` on and a `HostBackend` (any other
        backend keeps the Python walk, so block batches still go to the
        GPU)."""
        if self.frame_pump and isinstance(self.backend, HostBackend):
            return self.backend._native
        return None

    def _pump_raise(self, status: int):
        """The Python walk's error for the walker's status."""
        if status == -2:
            raise FrameError("blockChecksum_invalid")
        if status == -3:
            raise FrameError("contentChecksum_invalid")
        if status == -4:
            raise FrameError("maxBlockSize_invalid")
        raise BlockDecodeError("malformed block (C frame walker)")

    def _pump_set_need(self, data, pos: int) -> None:
        """Size the next unit (block word + payload [+ block checksum], or
        endmark [+ content checksum]) from the walker's stage and 4 bytes
        of lookahead, so that a sub-unit tail buffers exactly."""
        if self._pump_bc.frame_stage(self._pump_state) == 1:
            self._need = 4                    # content checksum
            return
        if len(data) - pos >= 4:
            word = struct.unpack("<I", data[pos: pos + 4])[0]
            if word == 0:
                self._need = 4 + (4 if self._info.content_checksum
                                  else 0)
            else:
                size = word & ~BLOCK_UNCOMPRESSED_FLAG
                if size > self._info.block_max_size:
                    raise FrameError("maxBlockSize_invalid",
                                     f"block size {size}")
                self._need = 4 + size + (4 if self._info.block_checksum
                                         else 0)
        else:
            self._need = 4

    def _pump_feed(self, data: bytes, start: int) -> tuple[list, int]:
        """Drive the walker over data[start:]; returns (the decoded
        buffers, consumed). Consumes every complete unit and buffers a
        sub-unit tail in self._buf for the next feed."""
        bc = self._pump_bc
        st = self._pump_state
        pos = start
        out: list = []
        out_cap = max(2 * self._info.block_max_size, 1 << 22)
        while self._stage == self._PUMP:
            if self._buf:
                take = min(len(data) - pos, self._need - len(self._buf))
                if take > 0:
                    self._buf += data[pos: pos + take]
                    pos += take
                if len(self._buf) < self._need:
                    break
                chunk = bytes(self._buf)
                del self._buf[:]
                # a buffered unit holds at most one block: an arena of
                # block_max, not the bulk cap
                status, produced, used = bc.frame_pump(
                    st, chunk, 0, self._info.block_max_size)
                if len(produced):
                    out.append(produced)
                self._total_out += len(produced)
                if status < 0:
                    self._pump_raise(status)
                if status == 1:
                    self._finish()
                    break
                if used < len(chunk):
                    self._buf += chunk[used:]
                self._pump_set_need(bytes(self._buf), 0)
                if used == 0:
                    break          # a complete unit could not advance yet
                continue
            status, produced, used = bc.frame_pump(st, data, pos, out_cap)
            pos += used
            if len(produced):
                out.append(produced)
            self._total_out += len(produced)
            if status < 0:
                self._pump_raise(status)
            if status == 1:
                self._finish()
                break
            rem = len(data) - pos
            if used > 0 and rem > 0:
                continue           # stopped for output space: go again
            if rem == 0:
                break
            # a sub-unit tail: buffer it for the next feed
            self._pump_set_need(data, pos)
            take = min(rem, self._need)
            self._buf += data[pos: pos + take]
            pos += take
            if len(self._buf) < self._need:
                break
        return out, pos - start

    def _on_content_checksum(self, chunk: bytes) -> bytes:
        want = struct.unpack("<I", chunk)[0]
        if self.verify_checksums and self._xxh.digest() != want:
            raise FrameError("contentChecksum_invalid")
        self._finish()
        return b""

    def _finish(self) -> None:
        if (self._info.content_size is not None
                and self._info.frame_type == "lz4"
                and self._total_out != self._info.content_size):
            raise FrameError("frameSize_wrong",
                             f"declared {self._info.content_size}, "
                             f"decoded {self._total_out}")
        self._stage = self._DONE

    # ------------------------------------------------------------- legacy
    def _on_legacy_block_header(self, chunk: bytes) -> bytes:
        word = struct.unpack("<I", chunk)[0]
        # a following frame magic ends the legacy frame (lz4io.c behaviour)
        if word == LEGACY_MAGIC or word == LZ4F_MAGIC or \
           (word & LZ4F_MAGIC_SKIPPABLE_MASK) == LZ4F_MAGIC_SKIPPABLE_START:
            self._legacy_next_magic = chunk
            self._stage = self._DONE
            return b""
        if word > LEGACY_BLOCKSIZE + LEGACY_BLOCKSIZE // 255 + 64:
            raise FrameError("maxBlockSize_invalid", f"legacy block {word}")
        self._stage = self._LEGACY_BLOCK_DATA
        self._need = word
        return b""

    def _on_legacy_block_data(self, chunk: bytes) -> bytes:
        decoded = self.backend.decompress_batch(
            [chunk], [LEGACY_BLOCKSIZE], dict_prefixes=[None])[0]
        self._total_out += len(decoded)
        if len(decoded) < LEGACY_BLOCKSIZE:
            # last block of the legacy frame
            self._stage = self._DONE
        else:
            self._stage = self._LEGACY_BLOCK_HEADER
            self._need = 4
        return decoded

    @property
    def legacy_lookahead(self) -> bytes:
        """4 bytes of the next frame's magic consumed while detecting the
        end of a legacy frame (to be re-fed by the caller)."""
        return getattr(self, "_legacy_next_magic", b"")

    @property
    def at_legacy_eof_boundary(self) -> bool:
        """True when a legacy frame may legitimately end here (awaiting a
        next block header with nothing buffered): legacy frames carry no
        end marker, EOF terminates them."""
        return (self._stage == self._LEGACY_BLOCK_HEADER
                and not self._buf)


def decompress_frame(data: bytes, *, backend: BlockBackend | None = None,
                     dict_content: bytes | None = None,
                     max_frames: int | None = None) -> bytes:
    """One-shot: decode all concatenated frames in `data`
    (multi-frame loop analog of lz4io.c:2429-2436)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    frames = 0
    while pos < len(data):
        dec = FrameDecompressor(backend=backend, dict_content=dict_content)
        produced, consumed = dec.feed(data[pos:])
        out += produced
        la = dec.legacy_lookahead
        pos += consumed - len(la)
        if not dec.frame_done:
            if dec.at_legacy_eof_boundary and pos >= len(data):
                break
            raise FrameError("frameDecoding_alreadyStarted",
                             "truncated frame")
        frames += 1
        if max_frames is not None and frames >= max_frames:
            break
    return bytes(out)
