"""LZ4 frame container: header/descriptor encoding and parsing (the
port's own copy of lz4_tpu/frame/format.py).

Normative spec: lz4's doc/lz4_Frame_format.md (magic, FLG/BD bits,
optional content-size / dictID fields, header-checksum byte, block
headers with the uncompressed flag, endmark, checksums, skippable +
legacy frames).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from lz4_tpu_torch.constants import (
    BLOCK_SIZES,
    DEFAULT_BLOCK_SIZE_ID,
    LEGACY_MAGIC,
    LZ4F_MAGIC,
    LZ4F_MAGIC_SKIPPABLE_MASK,
    LZ4F_MAGIC_SKIPPABLE_START,
    LZ4F_VERSION,
)
from lz4_tpu_torch.xxh32 import xxh32


class FrameError(ValueError):
    """LZ4F error analog (lz4frame.c:289-327's error codes become typed
    Python exceptions; `.code` carries a stable name)."""

    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}{': ' + msg if msg else ''}")
        self.code = code


@dataclass
class FrameInfo:
    """LZ4F_frameInfo_t analog (lz4frame.h:181-190)."""
    block_size_id: int = DEFAULT_BLOCK_SIZE_ID
    block_independent: bool = True
    block_checksum: bool = False
    content_checksum: bool = True
    content_size: int | None = None
    dict_id: int | None = None
    frame_type: str = "lz4"          # "lz4" | "skippable" | "legacy"

    @property
    def block_max_size(self) -> int:
        return BLOCK_SIZES[self.block_size_id]


@dataclass
class Preferences:
    """LZ4F_preferences_t analog (lz4frame.h:192-198).

    `block_size` is the exact data-block cut size in bytes (the
    LZ4IO_prefs_t.blockSize analog, lz4io.c:286-300): the frame header
    still advertises the covering standard tier in BD, but blocks carry
    at most `block_size` input bytes — the CLI's -B#bytes contract
    (lz4cli.c:556-577, tests/test_custom_block_sizes.sh). None = cut at
    the tier max."""
    frame_info: FrameInfo = field(default_factory=FrameInfo)
    compression_level: int = 0
    auto_flush: bool = False
    favor_dec_speed: bool = False
    block_size: int | None = None


def get_block_size(block_size_id: int) -> int:
    """LZ4F_getBlockSize analog (lz4frame.h:649-747)."""
    if block_size_id not in BLOCK_SIZES:
        raise FrameError("maxBlockSize_invalid", str(block_size_id))
    return BLOCK_SIZES[block_size_id]


def write_frame_header(info: FrameInfo) -> bytes:
    flg = (LZ4F_VERSION << 6)
    if info.block_independent:
        flg |= 1 << 5
    if info.block_checksum:
        flg |= 1 << 4
    if info.content_size is not None:
        flg |= 1 << 3
    if info.content_checksum:
        flg |= 1 << 2
    if info.dict_id is not None:
        flg |= 1 << 0
    bd = (info.block_size_id & 7) << 4
    body = bytes([flg, bd])
    if info.content_size is not None:
        body += struct.pack("<Q", info.content_size)
    if info.dict_id is not None:
        body += struct.pack("<I", info.dict_id)
    hc = (xxh32(body, 0) >> 8) & 0xFF
    return struct.pack("<I", LZ4F_MAGIC) + body + bytes([hc])


def header_size(prefix: bytes) -> int:
    """Bytes needed for the full header given >= 5 prefix bytes
    (LZ4F_headerSize analog, lz4frame.c:1444)."""
    if len(prefix) < 5:
        raise FrameError("frameHeader_incomplete")
    magic = struct.unpack("<I", prefix[:4])[0]
    if (magic & LZ4F_MAGIC_SKIPPABLE_MASK) == LZ4F_MAGIC_SKIPPABLE_START:
        return 8
    if magic == LEGACY_MAGIC:
        return 4
    if magic != LZ4F_MAGIC:
        raise FrameError("frameType_unknown", f"magic 0x{magic:08X}")
    flg = prefix[4]
    size = 7
    if flg & (1 << 3):
        size += 8
    if flg & (1 << 0):
        size += 4
    return size


def parse_frame_header(data: bytes) -> tuple[FrameInfo, int]:
    """Parse a frame header; returns (info, consumed_bytes).

    LZ4F_decodeHeader analog (lz4frame.c:1346-1437): validates magic,
    version, reserved bits and the header checksum byte.
    """
    if len(data) < 4:
        raise FrameError("frameHeader_incomplete")
    magic = struct.unpack("<I", data[:4])[0]
    if (magic & LZ4F_MAGIC_SKIPPABLE_MASK) == LZ4F_MAGIC_SKIPPABLE_START:
        if len(data) < 8:
            raise FrameError("frameHeader_incomplete")
        size = struct.unpack("<I", data[4:8])[0]
        info = FrameInfo(frame_type="skippable", content_size=size,
                         content_checksum=False)
        return info, 8
    if magic == LEGACY_MAGIC:
        return FrameInfo(frame_type="legacy", content_checksum=False,
                         block_size_id=7), 4
    if magic != LZ4F_MAGIC:
        raise FrameError("frameType_unknown", f"magic 0x{magic:08X}")
    need = header_size(data)
    if len(data) < need:
        raise FrameError("frameHeader_incomplete")
    flg, bd = data[4], data[5]
    if (flg >> 6) != LZ4F_VERSION:
        raise FrameError("headerVersion_wrong")
    if flg & 0x02:
        raise FrameError("reservedFlag_set")
    if bd & 0x8F:
        raise FrameError("reservedFlag_set")
    bsid = (bd >> 4) & 7
    if bsid not in BLOCK_SIZES:
        raise FrameError("maxBlockSize_invalid", str(bsid))
    pos = 6
    content_size = None
    if flg & (1 << 3):
        content_size = struct.unpack("<Q", data[pos:pos + 8])[0]
        pos += 8
    dict_id = None
    if flg & (1 << 0):
        dict_id = struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4
    hc = data[pos]
    pos += 1
    want = (xxh32(data[4:pos - 1], 0) >> 8) & 0xFF
    if hc != want:
        raise FrameError("headerChecksum_invalid")
    info = FrameInfo(
        block_size_id=bsid,
        block_independent=bool(flg & (1 << 5)),
        block_checksum=bool(flg & (1 << 4)),
        content_checksum=bool(flg & (1 << 2)),
        content_size=content_size,
        dict_id=dict_id,
    )
    return info, pos
