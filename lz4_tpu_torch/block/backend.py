"""Block-codec backend protocol (the port's counterpart of
lz4_tpu/block/backend.py).

The frame layer drives block compression through this interface (the
analog of lz4frame's compressFunc_t dispatch table, lz4frame.c:952-962).
Backends consume whole lists of blocks at once: frame-level batching is
the GPU's data-parallel decomposition. Two backends: `HostBackend` on the
port's host C tier (`lz4_tpu_torch.native`), and
`lz4_tpu_torch.parallel.engine.TorchBackend` on the GPU kernels, which is
the default.
"""
from __future__ import annotations

from typing import Protocol, Sequence


class BlockDecodeError(ValueError):
    """A compressed block is malformed or decodes past its cap."""


class BlockBackend(Protocol):
    def compress_batch(
        self,
        blocks: Sequence[bytes],
        *,
        level: int = 0,
        acceleration: int = 1,
        dict_prefixes: Sequence[bytes | None] | None = None,
        favor_dec_speed: bool = False,
        max_dist: int = 65535,
    ) -> list[bytes]:
        ...

    def decompress_batch(
        self,
        blocks: Sequence[bytes],
        max_outs: Sequence[int],
        *,
        dict_prefixes: Sequence[bytes | None] | None = None,
    ) -> list[bytes]:
        ...


class HostBackend:
    """BlockBackend on the host C tier (the counterpart of
    lz4_tpu.block.backend.HostBackend, on the port's C library only: a
    failed C build raises, and there is no Python fallback). HC levels
    (>= 2) run the C HC codec; `max_dist` < 65535 runs the capped fast
    codec and raises for HC levels, which do not honour the cap."""

    def __init__(self):
        from lz4_tpu_torch import native
        self._native = native.blockcodec

    def compress_batch(self, blocks, *, level=0, acceleration=1,
                       dict_prefixes=None, favor_dec_speed=False,
                       max_dist=65535):
        nc = self._native
        acceleration = max(1, acceleration)
        prefixes = list(dict_prefixes) if dict_prefixes else [None] * len(
            blocks)
        if max_dist < 65535:
            if level >= 2:
                raise ValueError(
                    "--max-dist applies to the fast tier only (level < 2)")
            return [nc.compress_maxd(b, max_dist, acceleration=acceleration,
                                     dict_prefix=d)
                    for b, d in zip(blocks, prefixes)]
        if level < 2 and not any(prefixes) and len(blocks) > 1:
            return nc.compress_batch(list(blocks), acceleration=acceleration)
        if level >= 2:
            return [nc.compress_hc(b, level=level, dict_prefix=d,
                                   favor_dec_speed=favor_dec_speed)
                    for b, d in zip(blocks, prefixes)]
        return [nc.compress(b, dict_prefix=d, acceleration=acceleration)
                for b, d in zip(blocks, prefixes)]

    def decompress_batch(self, blocks, max_outs, *, dict_prefixes=None):
        nc = self._native
        if not dict_prefixes or not any(dict_prefixes):
            return nc.decompress_batch(list(blocks), list(max_outs))
        return [nc.decompress(b, m, dict_prefix=d)
                for b, m, d in zip(blocks, max_outs, dict_prefixes)]


_DEFAULT: BlockBackend | None = None


def default_backend() -> BlockBackend:
    """Process-wide default backend: `TorchBackend()` on the GPU, made at
    first use (it raises where no GPU is present)."""
    global _DEFAULT
    if _DEFAULT is None:
        from lz4_tpu_torch.parallel.engine import TorchBackend
        _DEFAULT = TorchBackend()
    return _DEFAULT


def set_default_backend(b: BlockBackend | None) -> None:
    global _DEFAULT
    _DEFAULT = b
