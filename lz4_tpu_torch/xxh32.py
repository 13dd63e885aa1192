"""XXH32 — the port's own copy of lz4_tpu/xxh32.py, host side only.

Implements the published XXH32 specification (the algorithm is public:
https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md). Used for
the LZ4 frame header-checksum byte, optional block checksums and the
content checksum. Two forms: a one-shot function and a streaming
accumulator, both on the host C tier (`lz4_tpu_torch.native`, which
raises when it cannot be built). `xxh32_plain` is the same function in
Python, kept as the plain version the tests hold the C one against.
`xxh32_batch` hashes the rows of a batch on the host; the batched device
XXH32 is `lz4_tpu_torch.xxh32_device` (kernel B6).
"""
from __future__ import annotations

import numpy as np

_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D
_P4 = 0x27D4EB2F
_P5 = 0x165667B1
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M32, 13) * _P1) & _M32


def _avalanche(h: int) -> int:
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def _seed_accs(seed: int) -> list[int]:
    return [(seed + _P1 + _P2) & _M32, (seed + _P2) & _M32, seed,
            (seed - _P1) & _M32]


def _stripes(accs: list[int], data) -> list[int]:
    """Run the four lane accumulators over every whole 16-byte stripe."""
    nstripes = len(data) // 16
    words = np.frombuffer(memoryview(data)[: nstripes * 16],
                          dtype="<u4").tolist()
    a0, a1, a2, a3 = accs
    for i in range(0, 4 * nstripes, 4):
        a0 = _round(a0, words[i])
        a1 = _round(a1, words[i + 1])
        a2 = _round(a2, words[i + 2])
        a3 = _round(a3, words[i + 3])
    return [a0, a1, a2, a3]


def _tail(h: int, buf: bytes) -> int:
    pos = 0
    while pos + 4 <= len(buf):
        w = int.from_bytes(buf[pos:pos + 4], "little")
        h = (_rotl((h + w * _P3) & _M32, 17) * _P4) & _M32
        pos += 4
    while pos < len(buf):
        h = (_rotl((h + buf[pos] * _P5) & _M32, 11) * _P1) & _M32
        pos += 1
    return _avalanche(h)


def _merge(accs: list[int]) -> int:
    return (_rotl(accs[0], 1) + _rotl(accs[1], 7)
            + _rotl(accs[2], 12) + _rotl(accs[3], 18)) & _M32


def xxh32(data, seed: int = 0) -> int:
    """One-shot XXH32 of a bytes-like object (in C)."""
    from lz4_tpu_torch.native import xxh
    return xxh.xxh32(data, seed)


def xxh32_plain(data, seed: int = 0) -> int:
    """One-shot XXH32 in Python (the plain version of `xxh32`)."""
    data = bytes(data)
    n = len(data)
    seed &= _M32
    if n >= 16:
        h = _merge(_stripes(_seed_accs(seed), data))
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    return _tail(h, data[(n // 16) * 16:])


def xxh32_batch(blocks: np.ndarray, lengths, seed: int = 0) -> np.ndarray:
    """XXH32 of many equal-capacity blocks (uint8[B, cap]) with per-block
    lengths, as uint32[B], one C call per block (the host counterpart of
    the device hash `xxh32_device.xxh32_blocks`)."""
    from lz4_tpu_torch.native import xxh
    out = np.empty(blocks.shape[0], dtype=np.uint32)
    for i in range(blocks.shape[0]):
        out[i] = xxh.xxh32(blocks[i, : int(lengths[i])].tobytes(), seed)
    return out


class XXH32State:
    """Streaming XXH32 (reset/update/digest), mirroring the public
    streaming contract (xxhash.h:169-241 behaviourally)."""

    def __init__(self, seed: int = 0):
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        seed &= _M32
        self._seed = seed
        self._acc = _seed_accs(seed)
        self._buf = b""
        self._total = 0
        self._large = False

    def update(self, data) -> None:
        data = bytes(data)
        self._total += len(data)
        data = self._buf + data
        nstripes = len(data) // 16
        if nstripes:
            from lz4_tpu_torch.native import xxh
            self._large = True
            self._acc = xxh.xxh32_rounds(data[: nstripes * 16], self._acc)
        self._buf = data[nstripes * 16:]

    def digest(self) -> int:
        if self._large:
            h = _merge(self._acc)
        else:
            h = (self._seed + _P5) & _M32
        h = (h + self._total) & _M32
        return _tail(h, self._buf)
