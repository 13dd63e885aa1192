"""XXH64, one-shot in C and streaming in Python (the port's copy of
lz4_tpu/xxh64.py).

The LZ4 formats use only XXH32, but the reference vendors the xxHash
pair (lib/xxhash.c); XXH64 completes that surface. The algorithm is the
public xxHash64 specification, so the output must be bit-exact. `xxh64`
runs the port's C library (`native/xxh.c`), whose failed build raises:
there is no Python fallback.
"""
from __future__ import annotations

M64 = (1 << 64) - 1
P64_1 = 11400714785074694791
P64_2 = 14029467366897019727
P64_3 = 1609587929392839161
P64_4 = 9650029242287828579
P64_5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, val: int) -> int:
    acc = (acc + val * P64_2) & M64
    return (_rotl(acc, 31) * P64_1) & M64


def _merge(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * P64_1 + P64_4) & M64


def _finalize(h: int, tail: bytes) -> int:
    i, n = 0, len(tail)
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(tail[i:i + 8], "little"))
        h = (_rotl(h, 27) * P64_1 + P64_4) & M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(tail[i:i + 4], "little") * P64_1) & M64
        h = (_rotl(h, 23) * P64_2 + P64_3) & M64
        i += 4
    while i < n:
        h ^= (tail[i] * P64_5) & M64
        h = (_rotl(h, 11) * P64_1) & M64
        i += 1
    h ^= h >> 33
    h = (h * P64_2) & M64
    h ^= h >> 29
    h = (h * P64_3) & M64
    h ^= h >> 32
    return h


def xxh64(data: bytes, seed: int = 0) -> int:
    """One-shot XXH64 of `data` in C."""
    from lz4_tpu_torch.native import xxh
    return xxh.xxh64(data, seed)


class XXH64State:
    """Streaming XXH64 (reset/update/digest)."""

    def __init__(self, seed: int = 0):
        self.seed = seed & M64
        self.reset()

    def reset(self) -> "XXH64State":
        s = self.seed
        self._v = [(s + P64_1 + P64_2) & M64, (s + P64_2) & M64, s,
                   (s - P64_1) & M64]
        self._buf = b""
        self._total = 0
        return self

    def update(self, data: bytes) -> "XXH64State":
        data = bytes(data)
        self._total += len(data)
        buf = self._buf + data
        v = self._v
        i = 0
        while i + 32 <= len(buf):
            for k in range(4):
                v[k] = _round(v[k], int.from_bytes(
                    buf[i + 8 * k: i + 8 * k + 8], "little"))
            i += 32
        self._buf = buf[i:]
        return self

    def digest(self) -> int:
        v = self._v
        if self._total >= 32:
            h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
                 + _rotl(v[3], 18)) & M64
            for k in range(4):
                h = _merge(h, v[k])
        else:
            h = (self.seed + P64_5) & M64
        h = (h + self._total) & M64
        return _finalize(h, self._buf)
