"""Block-codec backend protocol (the port's counterpart of
lz4_tpu/block/backend.py).

The frame layer drives block compression through this interface (the
analog of lz4frame's compressFunc_t dispatch table, lz4frame.c:952-962).
Backends consume whole lists of blocks at once: frame-level batching is
the GPU's data-parallel decomposition. The port's one backend so far is
`lz4_tpu_torch.parallel.engine.TorchBackend`.
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
