"""In-memory benchmark harness (the port's own copy of
lz4_tpu/bench_harness.py): the CLI's `-b#` / `-e#` mode, the `lz4 -b`
analog (programs/bench.c).

Methodology parity (bench.c:360-620): the input is split into
independent blocks at the frame block size, compression and
decompression run in separate best-of timed loops (>= nb_seconds each),
and every round trip is XXH32-verified. Reports MB/s and ratio per
level, on the host clock around whole backend calls (host work
included).
"""
from __future__ import annotations

import struct
import sys
import time

from lz4_tpu_torch.block.backend import default_backend
from lz4_tpu_torch.constants import BLOCK_SIZES, LEGACY_MAGIC, LZ4F_MAGIC
from lz4_tpu_torch.xxh32 import xxh32

NB_SECONDS_DEFAULT = 3.0


def _split(data: bytes, bs: int) -> list[bytes]:
    return [data[i: i + bs] for i in range(0, len(data), bs)] or [b""]


def _timed_best(fn, nb_seconds: float):
    """Best time of fn() over at least two runs and nb_seconds."""
    best = float("inf")
    elapsed = 0.0
    runs = 0
    result = None
    while elapsed < nb_seconds or runs < 2:
        t0 = time.perf_counter()
        result = fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        elapsed += dt
        runs += 1
    return best, result


def bench_mem(data: bytes, level: int, prefs, *, backend=None,
              nb_seconds: float = NB_SECONDS_DEFAULT,
              dictionary: bytes | None = None) -> dict:
    """BMK_benchMem analog: returns {level, ratio, comp_MBs, dec_MBs,
    csize}. `dictionary` benches the dict-compression path (bench.c
    dictBuf)."""
    backend = backend or default_backend()
    blocks = _split(data, BLOCK_SIZES[prefs.block_size_id])
    dict_prefixes = [dictionary] * len(blocks) if dictionary else None
    crc_orig = xxh32(data)

    t_comp, comp = _timed_best(lambda: backend.compress_batch(
        blocks, level=level, acceleration=prefs.acceleration,
        dict_prefixes=dict_prefixes), nb_seconds)
    csize = sum(len(c) for c in comp)
    # stored-block fallback parity with the frame layer: oversized
    # compressed blocks would be stored raw on the wire
    wire = sum(min(len(c), len(b)) + 4 for c, b in zip(comp, blocks))

    max_outs = [len(b) for b in blocks]
    t_dec, dec = _timed_best(lambda: backend.decompress_batch(
        comp, max_outs, dict_prefixes=dict_prefixes), nb_seconds)
    if xxh32(b"".join(dec)) != crc_orig:
        raise RuntimeError("benchmark round-trip corruption detected")

    n = len(data)
    return {
        "level": level,
        "ratio": n / wire if wire else 0.0,
        "comp_MBs": (n / 1e6) / t_comp,
        "dec_MBs": (n / 1e6) / t_dec,
        "csize": csize,
    }


def bench_decode_only(blob: bytes, *, backend=None,
                      nb_seconds: float = NB_SECONDS_DEFAULT) -> dict:
    """Decode-only benchmark of an existing .lz4 file (bench.c:126-143
    behaviour when inputs are already compressed)."""
    from lz4_tpu_torch.frame.reader import decompress_frame
    best, out = _timed_best(lambda: decompress_frame(blob, backend=backend),
                            nb_seconds)
    return {"level": 0, "ratio": len(out) / len(blob) if blob else 0.0,
            "comp_MBs": 0.0, "dec_MBs": (len(out) / 1e6) / best,
            "csize": len(blob)}


def bench_files(paths: list[str], levels: list[int], prefs, *,
                backend=None, nb_seconds: float = NB_SECONDS_DEFAULT,
                out=sys.stderr) -> list[dict]:
    datas = []
    for p in paths:
        if p == "-":
            datas.append(sys.stdin.buffer.read())
        else:
            with open(p, "rb") as f:
                datas.append(f.read())
    data = b"".join(datas)
    # decode-only mode when every input is already an LZ4 frame
    if all(len(d) >= 4 and struct.unpack("<I", d[:4])[0] in
           (LZ4F_MAGIC, LEGACY_MAGIC) for d in datas):
        results = []
        for d in datas:
            r = bench_decode_only(d, backend=backend, nb_seconds=nb_seconds)
            results.append(r)
            out.write("decode-only: %9d -> ratio %5.3f, %7.1f MB/s\n" % (
                r["csize"], r["ratio"], r["dec_MBs"]))
        return results
    dictionary = None
    if getattr(prefs, "dictionary_filename", None):
        from lz4_tpu_torch.io.engine import load_dictionary
        cd = load_dictionary(prefs)
        dictionary = cd.content if cd else None
    results = []
    for level in levels:
        r = bench_mem(data, level, prefs, backend=backend,
                      nb_seconds=nb_seconds, dictionary=dictionary)
        results.append(r)
        out.write(
            "%2d : %9d -> %9d (%5.3f), %7.1f MB/s, %7.1f MB/s\n" % (
                level, len(data), r["csize"], r["ratio"],
                r["comp_MBs"], r["dec_MBs"]))
    return results
