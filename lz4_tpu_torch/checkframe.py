"""Standalone LZ4 frame validator — the port's copy of the JAX package's
`tools/checkframe.py` (the reference's tests/checkFrame.c): walks every
frame in a file, validating magic numbers, FLG/BD reserved bits, the
header checksum byte, block-size bounds, and end marks, WITHOUT decoding
block contents (use `python -m lz4_tpu_torch.cli -t` for full content
verification). Host work only: nothing here touches a device.

Usage: python -m lz4_tpu_torch.checkframe FILE [FILE...]
Exit code 0 = all frames structurally valid, 1 = any invalid.
"""
from __future__ import annotations

import struct
import sys

from lz4_tpu_torch.xxh32 import xxh32

MAGIC_LZ4F = 0x184D2204
MAGIC_LEGACY = 0x184C2102
MAGIC_SKIP_LO = 0x184D2A50
MAGIC_SKIP_HI = 0x184D2A5F
BLOCK_SIZES = {4: 65536, 5: 262144, 6: 1048576, 7: 4194304}


class FrameError(ValueError):
    pass


def _need(buf: bytes, off: int, n: int) -> None:
    if off + n > len(buf):
        raise FrameError(f"truncated at offset {off} (need {n} bytes)")


def check_lz4f(buf: bytes, off: int) -> tuple[int, dict]:
    start = off
    off += 4
    _need(buf, off, 3)
    flg, bd = buf[off], buf[off + 1]
    if (flg >> 6) != 1:
        raise FrameError(f"bad version bits in FLG at {off}")
    if flg & 0x02:
        raise FrameError(f"reserved FLG bit set at {off}")
    if bd & 0x8F:
        raise FrameError(f"reserved BD bits set at {off + 1}")
    bsid = (bd >> 4) & 7
    if bsid not in BLOCK_SIZES:
        raise FrameError(f"invalid block size id {bsid}")
    b_indep = bool(flg & 0x20)
    b_csum = bool(flg & 0x10)
    c_size = bool(flg & 0x08)
    c_csum = bool(flg & 0x04)
    dict_id = bool(flg & 0x01)
    hlen = 2 + (8 if c_size else 0) + (4 if dict_id else 0)
    _need(buf, off, hlen + 1)
    hc = (xxh32(buf[off: off + hlen]) >> 8) & 0xFF
    if buf[off + hlen] != hc:
        raise FrameError(f"header checksum mismatch at {off + hlen}")
    content_size = None
    if c_size:
        content_size = struct.unpack_from("<Q", buf, off + 2)[0]
    off += hlen + 1
    nblocks = 0
    comp_bytes = 0
    max_bs = BLOCK_SIZES[bsid]
    while True:
        _need(buf, off, 4)
        bsz = struct.unpack_from("<I", buf, off)[0]
        off += 4
        if bsz == 0:
            break                      # EndMark
        uncompressed = bool(bsz & 0x80000000)
        dlen = bsz & 0x7FFFFFFF
        if dlen > max_bs + (0 if uncompressed else max_bs // 255 + 16):
            raise FrameError(f"block at {off - 4} exceeds the tier "
                             f"({dlen} > {max_bs})")
        _need(buf, off, dlen + (4 if b_csum else 0))
        off += dlen + (4 if b_csum else 0)
        nblocks += 1
        comp_bytes += dlen
    if c_csum:
        _need(buf, off, 4)
        off += 4
    return off, {
        "type": "lz4f", "start": start, "blocks": nblocks,
        "block_size_id": bsid, "independent": b_indep,
        "block_checksum": b_csum, "content_checksum": c_csum,
        "content_size": content_size, "compressed": off - start,
    }


def check_legacy(buf: bytes, off: int) -> tuple[int, dict]:
    start = off
    off += 4
    nblocks = 0
    while off + 4 <= len(buf):
        bsz = struct.unpack_from("<I", buf, off)[0]
        # the next frame's magic ends a legacy stream
        if bsz == MAGIC_LZ4F or bsz == MAGIC_LEGACY or \
                MAGIC_SKIP_LO <= bsz <= MAGIC_SKIP_HI:
            break
        off += 4
        if bsz > 8 * 1024 * 1024 + 8 * 1024 * 1024 // 255 + 16:
            raise FrameError(f"legacy block at {off - 4} oversized")
        _need(buf, off, bsz)
        off += bsz
        nblocks += 1
    return off, {"type": "legacy", "start": start, "blocks": nblocks,
                 "compressed": off - start}


def check_skippable(buf: bytes, off: int) -> tuple[int, dict]:
    start = off
    _need(buf, off, 8)
    size = struct.unpack_from("<I", buf, off + 4)[0]
    _need(buf, off + 8, size)
    return off + 8 + size, {"type": "skippable", "start": start,
                            "size": size}


def check_file(path: str) -> list[dict]:
    with open(path, "rb") as f:
        buf = f.read()
    frames = []
    off = 0
    if not buf:
        raise FrameError("empty file")
    while off < len(buf):
        _need(buf, off, 4)
        magic = struct.unpack_from("<I", buf, off)[0]
        if magic == MAGIC_LZ4F:
            off, info = check_lz4f(buf, off)
        elif magic == MAGIC_LEGACY:
            off, info = check_legacy(buf, off)
        elif MAGIC_SKIP_LO <= magic <= MAGIC_SKIP_HI:
            off, info = check_skippable(buf, off)
        else:
            raise FrameError(f"unknown magic 0x{magic:08X} at {off}")
        frames.append(info)
    return frames


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 1
    rc = 0
    for path in argv:
        try:
            frames = check_file(path)
            desc = ", ".join(
                f"{fr['type']}({fr.get('blocks', fr.get('size', 0))})"
                for fr in frames)
            print(f"{path}: OK — {len(frames)} frame(s): {desc}")
        except (FrameError, OSError) as e:
            print(f"{path}: INVALID — {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
