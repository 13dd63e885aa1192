"""The port's benchmark: one JSON line on stdout.

    python -m lz4_tpu_torch.bench [--mb 48] [--seconds 3] [--block 65536]
                                  [--device cuda]

`main(...)` takes the same four settings for in-process callers. The
methodology is `bench.py`'s (the reference's `lz4 -b`: independent
blocks of a real-file corpus, best-of timed loops of at least `seconds`
per direction, a checked round trip), on the port's kernels:

- headline: B1 compress and B2 decompress of the whole corpus as one
  device-resident batch (`metric=compress_throughput`, `value`, and
  `detail.decompress_MBs`, `ratio`);
- the round-trip check: B6 hashes the decoded rows on the device, and
  they must equal the host XXH32 of each source block (a mismatch
  raises);
- device HC: B5 at levels 3 and 9 on the first 32 blocks;
- the wave tier on the first 128 blocks: B3 on the host C splitter's
  arenas, and B4 (`max_dist=2048`) with the host C emitter timed apart;
- the host C tier (`HostBackend`) on the whole corpus;
- the end-to-end CLI decode: `io.engine.decompress_file` of the corpus
  written as a default-preferences file, through `TorchBackend`.

Kernel stages are timed with CUDA events on a GPU (the host clock on
the CPU, where the plain versions run); the host, wave-emit and CLI
stages with the host clock. The result names its device. Nothing here
is compared with TPU-era or liblz4 numbers. Any failure raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from lz4_tpu_torch import native
from lz4_tpu_torch.block import decode_wave, encode_wave
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.batch import pack_blocks, resolve_device
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc
from lz4_tpu_torch.io.engine import IoPrefs, compress_file, decompress_file
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.realcorpus import describe, real_corpus
from lz4_tpu_torch.xxh32_device import xxh32_blocks

MAX_RUNS = 30
HC_BLOCKS = 32
WAVE_BLOCKS = 128


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _best_ms(fn, seconds: float, cuda: bool) -> float:
    """Best time of fn() in ms, after a warm-up, over at least two runs
    and `seconds` (CUDA events on a GPU, else the host clock)."""
    fn()
    best = float("inf")
    spent = 0.0
    runs = 0
    while (spent < seconds * 1e3 or runs < 2) and runs < MAX_RUNS:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
        spent += ms
        runs += 1
    return best


def _host_best_ms(fn, runs: int = 3):
    """Best host-clock ms of `runs` calls of fn(), and its last result."""
    best = float("inf")
    r = None
    for _ in range(runs):
        t0 = time.perf_counter()
        r = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, r


def _mbs(nbytes: int, ms: float) -> float:
    return nbytes / 1e6 / (ms / 1e3)


def main(*, mb: float = 48, seconds: float = 3.0, block: int = 65536,
         device=None) -> dict:
    """Run every stage, print the JSON line, and return it as a dict."""
    if not (16 <= block <= 65536 and block % 16 == 0):
        raise ValueError(f"block must be a multiple of 16 in [16, 65536], "
                         f"got {block}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    data = real_corpus(int(mb * (1 << 20)))
    n = len(data) - len(data) % block
    if n == 0:
        raise ValueError(f"a {mb} MB corpus holds no {block}-byte block")
    data = data[:n]
    blocks = [data[i: i + block] for i in range(0, n, block)]
    B = len(blocks)
    _log(f"{describe(data)}, {B} blocks of {block} on {dev}")
    src_h, lens_h, _, _ = pack_blocks(blocks, cap=block)
    src = torch.from_numpy(src_h).to(dev)
    lens = torch.from_numpy(lens_h).to(dev)

    # headline: B1 and B2 on the device-resident batch
    t_enc = _best_ms(lambda: encode_blocks(src, lens, cap_n=block), seconds,
                     cuda)
    comp, clens, _ = encode_blocks(src, lens, cap_n=block)
    csum = int(clens.sum())
    t_dec = _best_ms(lambda: decode_blocks(comp, clens, cap_out=block),
                     seconds, cuda)
    dec, olens, errs = decode_blocks(comp, clens, cap_out=block)
    if bool(errs.any()) or not bool((olens == block).all()):
        raise RuntimeError("B2 flagged an error or a short block")
    _log(f"B1 {_mbs(n, t_enc):.1f} MB/s, B2 {_mbs(n, t_dec):.1f} MB/s, "
         f"ratio {n / csum:.4f}")

    # round trip: B6 on the decoded rows against host XXH32 of the source
    got = xxh32_blocks(dec, olens, cap=block).cpu().tolist()
    want = [native.xxh.xxh32(b) for b in blocks]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise RuntimeError(f"round trip differs (device XXH32) in blocks "
                           f"{bad[:8]}")
    _log(f"round trip verified: device XXH32 of {B} decoded blocks")

    # device HC: B5 at levels 3 and 9
    hb = min(HC_BLOCKS, B)
    hc = {}
    for level in (3, 9):
        t = _best_ms(lambda: encode_blocks_hc(src[:hb], lens[:hb],
                                              cap_n=block, level=level),
                     seconds, cuda)
        out, cs, _ = encode_blocks_hc(src[:hb], lens[:hb], cap_n=block,
                                      level=level)
        first = out[0, : int(cs[0])].cpu().numpy().tobytes()
        if native.blockcodec.decompress(first, block) != blocks[0]:
            raise RuntimeError(f"B5 level {level} stream does not decode")
        hc[f"device_hc{level}_batch_MBs"] = _mbs(hb * block, t)
    _log(f"device HC ({hb} blocks): {hc}")

    # the wave tier: B3 on the C splitter's arenas, B4 + the C emitter
    wb = blocks[:WAVE_BLOCKS]
    wn = len(wb) * block
    bc = native.blockcodec
    wcomp = bc.compress_batch(wb)
    np_ = 4
    while np_ * 1024 < block:
        np_ *= 4
    arenas, out_lens = bc.wave_split_batch(wcomp, max_pieces=np_,
                                           out_caps=[block] * len(wb))
    a_d = torch.from_numpy(arenas).to(dev)
    n_d = torch.from_numpy(out_lens).to(dev)
    t_wave = _best_ms(lambda: decode_wave.wave_decode(a_d, n_d), seconds,
                      cuda)
    wout = decode_wave.wave_decode(a_d, n_d).cpu().numpy()
    if [wout[i, :block].tobytes() for i in range(len(wb))] != wb:
        raise RuntimeError("B3 output differs from the source")
    inp, ilens = encode_wave.pack_input(wb, encode_wave.rows_for(block))
    inp_d = torch.from_numpy(inp).to(dev)
    ilens_d = torch.from_numpy(ilens).to(dev)
    t_match = _best_ms(lambda: encode_wave.find_matches(inp_d, ilens_d),
                       seconds, cuda)
    decisions = encode_wave.find_matches(inp_d, ilens_d).cpu().numpy()
    t_emit, wstreams = _host_best_ms(
        lambda: bc.wave_emit_decisions(wb, decisions))
    if bc.decompress_batch(wstreams, [block] * len(wb)) != wb:
        raise RuntimeError("wave-encoded streams do not decode")
    wave = {"wave_decode_MBs": _mbs(wn, t_wave),
            "wave_encode_MBs": _mbs(wn, t_match),
            "wave_encode_size_vs_uncapped":
                sum(map(len, wstreams)) / sum(map(len, wcomp)),
            "wave_emit_host_MBs": _mbs(wn, t_emit)}
    _log(f"wave tier ({len(wb)} blocks): {wave}")

    # the host C tier
    host = HostBackend()
    t_hc, hcomp = _host_best_ms(lambda: host.compress_batch(blocks, level=1))
    t_hd, hout = _host_best_ms(
        lambda: host.decompress_batch(hcomp, [block] * B))
    if hout != blocks:
        raise RuntimeError("host C round trip differs")

    # end to end: the CLI's file decode through TorchBackend
    be = TorchBackend(dev)
    with tempfile.TemporaryDirectory() as tdir:
        srcf = os.path.join(tdir, "corpus.bin")
        lz4f = srcf + ".lz4"
        outf = os.path.join(tdir, "corpus.out")
        with open(srcf, "wb") as f:
            f.write(data)
        compress_file(srcf, lz4f, IoPrefs(verbosity=0), backend=be)
        t_cli, _ = _host_best_ms(lambda: decompress_file(
            lz4f, outf, IoPrefs(verbosity=0), backend=be))
        with open(outf, "rb") as f:
            if native.xxh.xxh32(f.read()) != native.xxh.xxh32(data):
                raise RuntimeError("CLI decode differs from the source")

    result = {
        "metric": "compress_throughput",
        "value": _mbs(n, t_enc),
        "unit": "MB/s",
        "detail": {
            "decompress_MBs": _mbs(n, t_dec),
            "ratio": n / csum,
            **hc,
            "hc_batch_blocks": hb,
            **wave,
            "wave_blocks": len(wb),
            "host_compress_MBs": _mbs(n, t_hc),
            "host_decompress_MBs": _mbs(n, t_hd),
            "cli_decode_MBs": _mbs(n, t_cli),
            "roundtrip": "device XXH32 of every decoded block",
            "corpus": "real",
            "corpus_MB": mb,
            "block": block,
            "device": dev.type,
            "kind": (torch.cuda.get_device_name(dev) if cuda
                     else "CPU (plain PyTorch versions)"),
        },
    }
    print(json.dumps(result), flush=True)
    return result


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m lz4_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--mb", type=float, default=48,
                   help="corpus size in MiB (default 48)")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="least seconds per timed loop (default 3)")
    p.add_argument("--block", type=int, default=65536,
                   help="block size in bytes (default 65536)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; raises without one)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(_parse(sys.argv[1:])))
