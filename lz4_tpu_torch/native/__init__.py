"""Host C tier: the block codec, HC codec, frame walker, XXH32 and XXH64
in C (`*.c` here, the port's own copies), built at first use with the
system C compiler and loaded with ctypes.

The library goes into the git-ignored `lz4_tpu_torch/_build/`; its name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. A build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
library. A failed build raises: there is no Python fallback.

Two facades keep the method names and return types of the JAX package's
host tier: `xxh` (one-shot XXH32 and XXH64, and the stripe rounds of
the streaming XXH32) and `blockcodec` (fast, capped, dest-size and HC
block compression, strict decode, the wave tier's splitter and emitter,
the big-block stream splitter and the frame pump). The batch calls of
the wave tier split a large batch into contiguous spans of rows, one C
call per host core at once: ctypes releases the GIL during a call, and
each row's result does not depend on the others.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lz4_tpu_torch.block.backend import BlockDecodeError
from lz4_tpu_torch.constants import compress_bound

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ("-O3", "-fPIC", "-shared", "-std=c11", "-Wall")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_L = ctypes.c_long
_CP = ctypes.c_char_p
_I32P = ctypes.POINTER(ctypes.c_int32)
SPAN_ROWS = 32      # fewest batch rows worth a host thread of their own


def sources() -> list[str]:
    return [os.path.join(_HERE, f) for f in sorted(os.listdir(_HERE))
            if f.endswith(".c")]


def library_path() -> str:
    key = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            key.update(f.read())
    return os.path.join(BUILD_DIR, f"lz4t_native-{key.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library if it is not built yet; returns its path.
    Raises RuntimeError when the compiler is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", tmp, *sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"lz4_tpu_torch: C build failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("lz4_tpu_torch: C build failed:\n" + proc.stderr)
    os.replace(tmp, so)
    return so


def _configure(lib: ctypes.CDLL) -> None:
    sigs = {
        "lz4t_xxh32": (ctypes.c_uint32, [_CP, ctypes.c_size_t,
                                         ctypes.c_uint32]),
        "lz4t_xxh32_rounds": (None, [_CP, ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_uint32)]),
        "lz4t_compress_block": (_L, [_CP, _L, _CP, _L, _L, ctypes.c_int]),
        "lz4t_compress_block_maxd": (_L, [_CP, _L, _CP, _L, _L,
                                          ctypes.c_int, _L]),
        "lz4t_compress_hc": (_L, [_CP, _L, _CP, _L, _L, ctypes.c_int,
                                  ctypes.c_int]),
        "lz4t_compress_lazy": (_L, [_CP, _L, _CP, _L, _L, ctypes.c_int,
                                    ctypes.c_int]),
        "lz4t_decompress_block": (_L, [_CP, _L, _CP, _L, _CP, _L]),
        "lz4t_compress_batch": (_L, [ctypes.POINTER(_CP), _I32P, _L, _P,
                                     _L, _I32P, ctypes.c_int]),
        "lz4t_decompress_batch": (_L, [ctypes.POINTER(_CP), _I32P, _L, _P,
                                       _L, _I32P, _I32P]),
        "lz4t_wave_split": (_L, [_CP, _L, _P, _L, _L, _L, _I32P]),
        "lz4t_wave_split_batch": (_L, [ctypes.POINTER(_CP), _I32P, _L, _P,
                                       _L, _I32P, _I32P]),
        "lz4t_wave_emit_decisions": (_L, [ctypes.POINTER(_CP), _I32P, _L,
                                          _I32P, _L, _P, _L, _I32P]),
        "lz4t_split_stream": (_L, [_CP, _L, _P, _L, _L, _L, _L, _I32P,
                                   _I32P]),
        "lz4t_xxh64": (ctypes.c_uint64, [_CP, ctypes.c_size_t,
                                         ctypes.c_uint64]),
        "lz4t_compress_destsize": (_L, [_CP, _L, _CP, _L,
                                        ctypes.POINTER(_L)]),
        "lz4t_frame_state_size": (_L, []),
        "lz4t_frame_stage": (_L, [_P]),
        "lz4t_frame_state_init": (None, [_P, ctypes.c_uint32,
                                         ctypes.c_uint32, _CP, _L]),
        "lz4t_frame_pump": (_L, [_P, _P, _L, _P, _L, ctypes.POINTER(_L),
                                 ctypes.POINTER(_L)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load() -> ctypes.CDLL:
    """The loaded library, building it at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            _configure(lib)
            _LIB = lib
        return _LIB


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _spans(n: int) -> list[tuple[int, int]]:
    """Contiguous row spans [i0, i1) of an n-row batch, one per thread:
    as many as the host has cores, with at least SPAN_ROWS rows each."""
    k = max(1, min(os.cpu_count() or 1, n // SPAN_ROWS))
    step = max(1, -(-n // k))
    return [(i, min(n, i + step)) for i in range(0, n, step)] or [(0, 0)]


def _over_spans(fn, n: int) -> list:
    """fn(i0, i1) for every span of an n-row batch, the spans at once."""
    spans = _spans(n)
    if len(spans) == 1:
        return [fn(*spans[0])]
    with ThreadPoolExecutor(len(spans)) as pool:
        return list(pool.map(lambda s: fn(*s), spans))


def _with_history(data: bytes, dict_prefix) -> tuple:
    """(buffer, src pointer, history length): the C codecs take src at
    the data start with the history contiguous before it."""
    d = bytes(dict_prefix or b"")[-65535:]
    buf = ctypes.create_string_buffer(d + data, len(d) + len(data))
    return buf, ctypes.cast(ctypes.byref(buf, len(d)), _CP), len(d)


class _XXH:
    """XXH32 and XXH64 in C."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def xxh32(self, data, seed: int = 0) -> int:
        data = bytes(data)
        return self._lib.lz4t_xxh32(data, len(data), seed & 0xFFFFFFFF)

    def xxh32_rounds(self, data, accs) -> list[int]:
        """Run the four stripe accumulators over every whole 16-byte
        stripe of `data`."""
        data = bytes(data)
        arr = (ctypes.c_uint32 * 4)(*[a & 0xFFFFFFFF for a in accs])
        self._lib.lz4t_xxh32_rounds(data, len(data), arr)
        return [arr[0], arr[1], arr[2], arr[3]]

    def xxh64(self, data, seed: int = 0) -> int:
        data = bytes(data)
        return self._lib.lz4t_xxh64(data, len(data), seed & 0xFFFFFFFFFFFFFFFF)


class _BlockCodec:
    """The C block codec: one call per block, or one per batch."""

    WAVE_OUT = 1024     # decoded bytes per wave piece
    WAVE_CAP = 1088     # arena bytes per wave piece slot

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def compress(self, data: bytes, dict_prefix: bytes | None = None,
                 acceleration: int = 1) -> bytes:
        data = bytes(data)
        _buf, src, dlen = _with_history(data, dict_prefix)
        cap = compress_bound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_compress_block(src, len(data), dst, cap, dlen,
                                          max(1, acceleration))
        if n <= 0:
            raise RuntimeError("C compression failed")
        return dst.raw[:n]

    def compress_maxd(self, data: bytes, max_dist: int,
                      acceleration: int = 1,
                      dict_prefix: bytes | None = None) -> bytes:
        """Fast compression with match offsets capped at max_dist."""
        data = bytes(data)
        _buf, src, dlen = _with_history(data, dict_prefix)
        cap = compress_bound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_compress_block_maxd(
            src, len(data), dst, cap, dlen, max(1, acceleration), max_dist)
        if n <= 0:
            raise RuntimeError("C compression failed")
        return dst.raw[:n]

    def compress_hc(self, data: bytes, level: int = 9,
                    dict_prefix: bytes | None = None,
                    favor_dec_speed: bool = False) -> bytes:
        data = bytes(data)
        _buf, src, dlen = _with_history(data, dict_prefix)
        cap = compress_bound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_compress_hc(src, len(data), dst, cap, dlen,
                                       level, 1 if favor_dec_speed else 0)
        if n <= 0:
            raise RuntimeError("C HC compression failed")
        return dst.raw[:n]

    def compress_lazy(self, data: bytes, tries: int,
                      dict_prefix: bytes | None = None,
                      favor_dec_speed: bool = False) -> bytes:
        """The lazy hash-chain tier at an explicit search depth
        (`compress_lazy` in hccodec.c): the byte oracle of kernel B5 at
        any depth, with or without `favor_dec_speed`."""
        data = bytes(data)
        _buf, src, dlen = _with_history(data, dict_prefix)
        cap = compress_bound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_compress_lazy(src, len(data), dst, cap, dlen,
                                         tries, 1 if favor_dec_speed else 0)
        if n <= 0:
            raise RuntimeError("C lazy compression failed")
        return dst.raw[:n]

    def decompress(self, comp: bytes, max_out: int,
                   dict_prefix: bytes | None = None) -> bytes:
        comp = bytes(comp)
        d = bytes(dict_prefix or b"")[-65535:]
        dst = ctypes.create_string_buffer(max(1, max_out))
        n = self._lib.lz4t_decompress_block(comp, len(comp), dst, max_out,
                                            d, len(d))
        if n < 0:
            raise BlockDecodeError("C decoder rejected stream")
        return dst.raw[:n]

    def compress_destsize(self, data: bytes,
                          dst_cap: int) -> tuple[bytes, int]:
        """Pack as much of `data` as fits in `dst_cap` compressed bytes
        (LZ4_compress_destSize). Returns (compressed, consumed source
        bytes)."""
        data = bytes(data)
        dst = ctypes.create_string_buffer(max(1, dst_cap))
        consumed = _L(0)
        n = self._lib.lz4t_compress_destsize(data, len(data), dst, dst_cap,
                                             ctypes.byref(consumed))
        return dst.raw[:n], consumed.value

    def compress_batch(self, blocks, acceleration: int = 1) -> list[bytes]:
        """Independent dict-less blocks in one C call."""
        n = len(blocks)
        if n == 0:
            return []
        blocks = [bytes(b) for b in blocks]
        stride = compress_bound(max(len(b) for b in blocks))
        lens = np.asarray([len(b) for b in blocks], np.int32)
        dst = np.empty((n, stride), np.uint8)
        sizes = np.empty(n, np.int32)
        r = self._lib.lz4t_compress_batch(
            (_CP * n)(*blocks), _i32p(lens), n,
            dst.ctypes.data_as(_P), stride, _i32p(sizes),
            max(1, acceleration))
        if r != 0:
            raise RuntimeError(f"C batch compression failed ({r})")
        return [dst[i, : sizes[i]].tobytes() for i in range(n)]

    def decompress_batch(self, blocks, max_outs) -> list[bytes]:
        """Independent dict-less blocks in one C call; raises
        BlockDecodeError naming the first malformed block."""
        n = len(blocks)
        if n == 0:
            return []
        blocks = [bytes(b) for b in blocks]
        stride = max(1, max(max_outs))
        clens = np.asarray([len(b) for b in blocks], np.int32)
        caps = np.asarray(max_outs, np.int32)
        dst = np.empty((n, stride), np.uint8)
        out_lens = np.empty(n, np.int32)
        r = self._lib.lz4t_decompress_batch(
            (_CP * n)(*blocks), _i32p(clens), n, dst.ctypes.data_as(_P),
            stride, _i32p(caps), _i32p(out_lens))
        if r != 0:
            raise BlockDecodeError(
                f"C decoder rejected stream (block {-r - 1})")
        return [dst[i, : out_lens[i]].tobytes() for i in range(n)]

    def wave_split(self, comp: bytes, *, max_pieces: int = 64,
                   out_cap: int = 65536, hist_len: int = 0):
        """Re-lay one LZ4 block stream into wave pieces (lz4t_wave_split):
        piece k holds exactly 1024 decoded bytes (the last may hold fewer)
        at arena byte k*1088. Returns (arena uint8[n_pieces, 1088],
        out_len), or None when the stream is malformed or over capacity.
        `hist_len` is the history available before position 0."""
        comp = bytes(comp)
        arena = np.zeros((max_pieces, self.WAVE_CAP), np.uint8)
        out_len = ctypes.c_int32(0)
        r = self._lib.lz4t_wave_split(
            comp, len(comp), arena.ctypes.data_as(_P), max_pieces, out_cap,
            hist_len, ctypes.byref(out_len))
        if r < 0:
            return None
        return arena[:r], int(out_len.value)

    def wave_split_batch(self, comps, *, max_pieces: int = 64,
                         out_caps=None):
        """Wave re-layout of a batch (one C call per span of rows, the
        spans at once): returns (arenas uint8[n, max_pieces, 1088],
        out_lens int32[n]), or None when any stream is malformed."""
        n = len(comps)
        comps = [bytes(c) for c in comps]
        arenas = np.zeros((n, max_pieces, self.WAVE_CAP), np.uint8)
        lens = np.asarray([len(c) for c in comps], np.int32)
        caps = np.asarray(out_caps if out_caps is not None
                          else [max_pieces * self.WAVE_OUT] * n, np.int32)
        out_lens = np.zeros(n, np.int32)

        def span(i0, i1):
            return self._lib.lz4t_wave_split_batch(
                (_CP * (i1 - i0))(*comps[i0:i1]), _i32p(lens[i0:i1]),
                i1 - i0, arenas[i0:i1].ctypes.data_as(_P), max_pieces,
                _i32p(caps[i0:i1]), _i32p(out_lens[i0:i1]))
        if any(r != 0 for r in _over_spans(span, n)):
            return None
        return arenas, out_lens

    def split_stream(self, comp: bytes, *, piece_cap: int = 66816,
                     max_pieces: int = 72, out_limit: int = 65536,
                     out_cap: int | None = None):
        """Split one LZ4 block stream into linked pieces of at most
        `out_limit` decoded bytes (lz4t_split_stream), cut at sequence
        granularity (literal runs and matches that cross a piece end are
        split), for the big-block piece-wave decode; the splitter itself
        enforces the whole block's end rules against `out_cap`. Returns
        (arena uint8[n_pieces, piece_cap], piece_lens int32[n_pieces],
        piece_outs int32[n_pieces]), or None when the stream is malformed
        or over capacity."""
        comp = bytes(comp)
        arena = np.zeros((max_pieces, piece_cap), np.uint8)
        plens = np.zeros(max_pieces, np.int32)
        pouts = np.zeros(max_pieces, np.int32)
        if out_cap is None:
            out_cap = max_pieces * out_limit
        r = self._lib.lz4t_split_stream(
            comp, len(comp), arena.ctypes.data_as(_P), piece_cap,
            max_pieces, out_limit, out_cap, _i32p(plens), _i32p(pouts))
        if r < 0:
            return None
        return arena[:r], plens[:r], pouts[:r]

    def wave_emit_decisions(self, blocks, decT) -> list[bytes]:
        """Serialize the wave match finder's decisions (int32[n, n_rows],
        one row per block) into standard LZ4 block streams (one C call
        per span of rows, the spans at once), with the host catch-up and
        the end-of-block re-checks."""
        n = len(blocks)
        if n == 0:
            return []
        blocks = [bytes(b) for b in blocks]
        decT = np.ascontiguousarray(decT, np.int32)
        stride = compress_bound(max(len(b) for b in blocks))
        lens = np.asarray([len(b) for b in blocks], np.int32)
        dst = np.empty((n, stride), np.uint8)
        sizes = np.empty(n, np.int32)

        def span(i0, i1):
            return self._lib.lz4t_wave_emit_decisions(
                (_CP * (i1 - i0))(*blocks[i0:i1]), _i32p(lens[i0:i1]),
                i1 - i0, _i32p(decT[i0:i1]), decT.shape[1],
                dst[i0:i1].ctypes.data_as(_P), stride, _i32p(sizes[i0:i1]))
        for r in _over_spans(span, n):
            if r != 0:
                raise RuntimeError(f"wave emit failed ({r})")
        return [dst[i, : sizes[i]].tobytes() for i in range(n)]

    # The frame pump (framewalk.c): one C call decodes a run of complete
    # frame blocks (block words, checksums, the linked 64 KB history and
    # the content XXH32), the decode loop of the reference's lz4io.c.

    FW_FLAG_BLOCK_CHECKSUM = 1
    FW_FLAG_INDEPENDENT = 2
    FW_FLAG_CONTENT_CHECKSUM = 4
    FW_FLAG_VERIFY = 8

    def frame_state_new(self, *, block_checksum: bool, independent: bool,
                        content_checksum: bool, verify: bool,
                        block_max: int, dict_content: bytes | None = None):
        """A walker state for one frame body, its history seeded with the
        last 64 KB of `dict_content`."""
        st = ctypes.create_string_buffer(self._lib.lz4t_frame_state_size())
        flags = ((self.FW_FLAG_BLOCK_CHECKSUM if block_checksum else 0)
                 | (self.FW_FLAG_INDEPENDENT if independent else 0)
                 | (self.FW_FLAG_CONTENT_CHECKSUM if content_checksum
                    else 0)
                 | (self.FW_FLAG_VERIFY if verify else 0))
        d = bytes(dict_content or b"")
        self._lib.lz4t_frame_state_init(st, flags, block_max, d, len(d))
        return st

    def frame_stage(self, st) -> int:
        """0 while the walker expects block words, 1 when it expects the
        content checksum."""
        return int(self._lib.lz4t_frame_stage(st))

    def frame_pump(self, st, data, offset: int, out_cap: int):
        """Decode the complete blocks of data[offset:] into a fresh arena
        of out_cap bytes (at least the frame's block_max). Returns
        (status, produced, consumed): status 1 when the frame ended, 0
        when it stopped for input or output space, -2 a block checksum,
        -3 the content checksum, -4 a block size over block_max, -5 a
        malformed block. `produced` is a memoryview over the arena, which
        nothing writes again."""
        view = np.frombuffer(data, np.uint8)[offset:]
        out = np.empty(out_cap, np.uint8)
        consumed = _L(0)
        produced = _L(0)
        status = self._lib.lz4t_frame_pump(
            st, view.ctypes.data_as(_P), view.size, out.ctypes.data_as(_P),
            out_cap, ctypes.byref(consumed), ctypes.byref(produced))
        return int(status), out[: produced.value].data, int(consumed.value)


def __getattr__(name: str):
    if name == "xxh":
        return _XXH(load())
    if name == "blockcodec":
        return _BlockCodec(load())
    raise AttributeError(name)
