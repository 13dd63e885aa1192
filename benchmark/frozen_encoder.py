"""The benchmark's frozen level-1 LZ4 block encoder (`frozen_encoder.c`),
built at first use with `cc` (or `$CC`) into `benchmark/_build/` and
loaded with ctypes.

It makes the decompress cells' streams and the compress cells' control,
so neither moves when the program's encoders change. The library's name
carries a hash of the source and flags; a build writes a temporary file
and renames it into place. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "frozen_encoder.c")
BUILD_DIR = os.path.join(HERE, "_build")
CFLAGS = ("-O3", "-fPIC", "-shared", "-std=c11", "-Wall")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
_CP = ctypes.c_char_p
_I32P = ctypes.POINTER(ctypes.c_int32)


def compress_bound(n: int) -> int:
    """Worst-case LZ4 block size of n input bytes (lz4.h)."""
    return n + n // 255 + 16


def library_path() -> str:
    key = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(SOURCE, "rb") as f:
        key.update(f.read())
    return os.path.join(BUILD_DIR, f"frozen_encoder-{key.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it is built; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("benchmark: frozen encoder build failed:\n"
                           + proc.stderr)
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.bench_compress_block.restype = ctypes.c_long
            lib.bench_compress_block.argtypes = [
                _CP, ctypes.c_long, _CP, ctypes.c_long, ctypes.c_long,
                ctypes.c_int]
            lib.bench_compress_batch.restype = ctypes.c_long
            lib.bench_compress_batch.argtypes = [
                ctypes.POINTER(_CP), _I32P, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, _I32P, ctypes.c_int]
            _LIB = lib
        return _LIB


def compress_rows(rows: np.ndarray, lens: np.ndarray,
                  acceleration: int = 1) -> list[bytes]:
    """Level-1 streams of independent blocks: row i of `rows` (uint8[B,
    cap], C-contiguous) up to lens[i]."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    b, cap = rows.shape
    stride = compress_bound(cap)
    out = np.empty((b, stride), np.uint8)
    sizes = np.zeros(b, np.int32)
    base = rows.ctypes.data
    ptrs = (_CP * b)(*[ctypes.cast(base + i * cap, _CP) for i in range(b)])
    rc = _lib().bench_compress_batch(
        ptrs, lens.ctypes.data_as(_I32P), b, out.ctypes.data, stride,
        sizes.ctypes.data_as(_I32P), acceleration)
    if rc != 0:
        raise RuntimeError(f"benchmark: frozen encoder failed on row "
                           f"{-rc - 1}")
    return [out[i, : sizes[i]].tobytes() for i in range(b)]


def compress_linked(block: bytes, history: bytes = b"",
                    acceleration: int = 1) -> bytes:
    """Level-1 stream of `block` with `history` (at most its last 64 KB)
    as the block's prefix: a linked block, whose matches may reach into
    the history."""
    hist = bytes(history)[-65535:]
    buf = ctypes.create_string_buffer(hist + bytes(block),
                                      len(hist) + len(block))
    src = ctypes.cast(ctypes.byref(buf, len(hist)), _CP)
    cap = compress_bound(len(block))
    dst = ctypes.create_string_buffer(cap)
    n = _lib().bench_compress_block(src, len(block), dst, cap, len(hist),
                                    acceleration)
    if n <= 0:
        raise RuntimeError("benchmark: frozen encoder failed")
    return dst.raw[:n]
