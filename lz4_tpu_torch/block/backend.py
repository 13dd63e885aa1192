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

import os
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


def default_nb_workers() -> int:
    """The host worker count by default: `LZ4_NBWORKERS` where it holds a
    number, else the reference CLI's cores - 1 - cores/8
    (programs/lz4io.c:177-187), at least 1."""
    env = os.environ.get("LZ4_NBWORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    cores = os.cpu_count() or 1
    return max(1, cores - 1 - cores // 8)


class HostBackend:
    """BlockBackend on the host C tier (the counterpart of
    lz4_tpu.block.backend.HostBackend, on the port's C library only: a
    failed C build raises, and there is no Python fallback). HC levels
    (>= 2) run the C HC codec; `max_dist` < 65535 runs the capped fast
    codec and raises for HC levels, which do not honour the cap.

    `nb_workers` > 1 fans the work out over a thread pool of that many
    workers (the reference's TPool engine, programs/threadpool.c): the
    batch C calls over contiguous ranges of blocks (`_chunked`), the
    per-block calls block by block (`_map`). ctypes releases the GIL
    during a C call, so the C codecs scale across cores; each block's
    bytes do not depend on the worker count."""

    def __init__(self, nb_workers: int = 0):
        from lz4_tpu_torch import native
        self._native = native.blockcodec
        self.nb_workers = nb_workers
        self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.nb_workers)
        return self._pool

    def _map(self, fn, items):
        """fn over items, on the pool when it has more than one worker."""
        if self.nb_workers > 1 and len(items) > 1:
            return list(self._executor().map(fn, items))
        return [fn(it) for it in items]

    def _chunked(self, batch_fn, blocks, *extra):
        """One batch C call per contiguous range of blocks, the ranges on
        the pool; list arguments in `extra` are cut with the blocks."""
        n = len(blocks)
        if self.nb_workers <= 1 or n <= 1:
            return batch_fn(blocks, *extra)
        w = min(self.nb_workers, n)
        bounds = [(i * n) // w for i in range(w + 1)]

        def part(k):
            lo, hi = bounds[k], bounds[k + 1]
            return batch_fn(blocks[lo:hi], *[
                e[lo:hi] if isinstance(e, (list, tuple)) else e
                for e in extra])
        out = []
        for p in self._executor().map(part, range(w)):
            out.extend(p)
        return out

    def compress_batch(self, blocks, *, level=0, acceleration=1,
                       dict_prefixes=None, favor_dec_speed=False,
                       max_dist=65535):
        nc = self._native
        acceleration = max(1, acceleration)
        prefixes = list(dict_prefixes) if dict_prefixes else [None] * len(
            blocks)
        items = list(zip(blocks, prefixes))
        if max_dist < 65535:
            if level >= 2:
                raise ValueError(
                    "--max-dist applies to the fast tier only (level < 2)")
            return self._map(lambda bd: nc.compress_maxd(
                bd[0], max_dist, acceleration=acceleration,
                dict_prefix=bd[1]), items)
        if level < 2 and not any(prefixes) and len(blocks) > 1:
            return self._chunked(
                lambda bs, acc: nc.compress_batch(bs, acceleration=acc),
                list(blocks), acceleration)
        if level >= 2:
            return self._map(lambda bd: nc.compress_hc(
                bd[0], level=level, dict_prefix=bd[1],
                favor_dec_speed=favor_dec_speed), items)
        return self._map(lambda bd: nc.compress(
            bd[0], dict_prefix=bd[1], acceleration=acceleration), items)

    def decompress_batch(self, blocks, max_outs, *, dict_prefixes=None):
        nc = self._native
        if (not dict_prefixes or not any(dict_prefixes)) and len(blocks) > 1:
            return self._chunked(nc.decompress_batch, list(blocks),
                                 list(max_outs))
        prefixes = list(dict_prefixes) if dict_prefixes else [None] * len(
            blocks)
        return self._map(lambda bmd: nc.decompress(
            bmd[0], bmd[1], dict_prefix=bmd[2]),
            list(zip(blocks, max_outs, prefixes)))


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
