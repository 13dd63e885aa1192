#!/usr/bin/env python3
"""Smoke run of the lz4_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from lz4_tpu_torch/csrc with nvcc (all at once,
the probe kernels P1-P4 too) and the host C library with cc, holds each
kernel (B1-B6) against its plain PyTorch version on the card (and B6
against the host C XXH32 on rows of 1 MB and 4 MB and on batches of 1, 7
and 768 rows), then drives
the port's paths through the entry points a user calls, each with every
launch count set to 0 just before it and read just after:

- the main path: the fast-tier block round trip through `TorchBackend`
  over a 48 MB real-file corpus in 64 KB blocks (B1 to compress; the
  wave tier, host C splitter plus B3, to decompress), and the same
  decompress with `wave_decode` off (B2); B1 alone on the 768 blocks
  (device tables) and on 64 of them (the CLI's call at `-B4`: solo, a
  whole SM a block), each with its path and against the plain version;
- the `max_dist=2048` path: B4 plus the host C emitter, round-tripped
  through the wave tier and the host C decoder;
- frames: 16 MB linked and independent frames through the sequential
  frame layer (B1; 4 MB linked blocks decode on the host, and on B2 with
  `decode_dest` "device"; 64 KB independent ones on B3), and 128 streams
  x 384 KiB through the batch frame surfaces (B4, B3), linked frames also
  through the sequential decoder (B2);
- the HC path: `TorchBackend.compress_batch(level=L)`, L = 3 and 9, over
  the 48 MB corpus in 64 KB blocks (one B5 launch each), byte-identical
  to the host C `compress_hc` and round-tripped; B5 alone on the 768
  blocks (width 1, no cluster launch) and on the first 64 (the CLI's call
  at `-B4`: width 2, a 2-CTA cluster a block, where the card holds 64
  such clusters), its bytes equal to the 768-block call's, every launch
  at width 2 counted in `encode_hc.cluster_launches`; B5's kernels entry
  carries both times, the width and the card's clusters;
- the level-2 path: the same batch on the sort/scan encoder (torch ops,
  no kernel launch), its bytes equal to the CPU's on sampled rows, a dict
  batch and blocks over 64 KB, round-tripped through the host C decoder;
- the CLI in process: `-9 -B4` (B5), `-d` and `-t` on a 16 MB file, and
  a default `-1` round trip;
- the port's bench at 8 MB and 1 s per timed loop (its round-trip check
  runs B6; B6 is also timed on the HC path's 48 MB batch: a launch after
  a sync, as every kernel's `ms`, and beside it launches back to back and
  one with the L2 flushed);
- the frame pump: three 16 MB frames decoded on `HostBackend` with the C
  frame walker and with the Python walk (bytes equal, pump calls
  counted), fed in 4099-byte and 1 MiB chunks, 64 mutated frames (the
  same error both ways), and the CLI's `--backend host -d`, timed by
  `lz4_tpu_torch/probes/host_frame.py`;
- the one-shot `lz4_tpu_torch.compress` / `decompress` on the default
  backend over the 48 MB corpus in 64 KB blocks (B1 and B3 independent,
  B1 and B2 linked, B5 and B3 at level 9), each frame also decoded on
  `HostBackend`; `xxh64` and `compress_destsize`;
- the 11 examples' main()s (`turbo_wave_mode` launches B4 and B3,
  `sharded_batch` runs on its own NCCL group of one);
- the port's host tools: the differential fuzzer
  (`lz4_tpu_torch/probes/torture.py`) for 45 s with `--kernels --wave`
  (B1, B2, the wave splitter with B3, the linked ring, the batch frames
  with B4) and 15 s on the sort/scan legs, every mutated stream held
  between host C and the card's decoders; the per-stage micro-benchmark
  (`probes/fullbench.py`) at the tool's defaults and level 2's encode
  and the sort/scan decode split at 768 x 64 KB; the frame validator
  (`lz4_tpu_torch/checkframe.py`) on the frames written above, a legacy
  and a skippable frame, and three corrupted copies that must fail;
- the TPU probes of `tools/` on their Hopper kernels (P1
  `probes/gather_probe.py`, P2/P3 `probes/walk_probe.py`, P4
  `probes/lane_probe.py`): every body timed at the tool's sizes, and the
  output of its last timed launch held against its plain version on the
  same inputs; the gathers also with the host's time a call, P1's lane,
  row and flat behind an L2 flush, and their `torch.gather` /
  `torch.take` on the same methods; P1 chase at the tool's shape (its
  cluster body) and at int32[32, 2048, 128] (its global-memory body),
  each a body of its own with its own launches; each chain body (P1
  chase and hops, P2, P3, P4's loops and wave) with its chain bound,
  priced by the latency build of `csrc/probe_walk.cu` at the SM clock
  nvidia-smi reads while the card is busy, held to be at most 1.03 times
  the SM cycles its clock64 measured on that chain, and printed as one
  {"chain_bounds": ...} line before the kernels line.

Any failure raises. The last line is {"ok": true, "device": {...}}; the
line before it is the card's name and power limit, before that a
{"kernels": [...]} line (each kernel's launches on the one-shot path, in
the examples and in the torture phase beside those of its own path), and
before that the {"chain_bounds": ...} line of the probe bodies. Needs one
CUDA GPU; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import ctypes
import filecmp
import importlib
import io
import json
import os
import re
import sys
import tempfile
import time
from collections import Counter
from dataclasses import asdict

import numpy as np
import torch

import lz4_tpu_torch
from lz4_tpu_torch import _build, bench, checkframe, cli, native, xxh32_device
from lz4_tpu_torch.block import (decode_cuda, decode_sortscan, decode_wave,
                                 encode_cuda, encode_hc, encode_sortscan,
                                 encode_wave)
from lz4_tpu_torch.block.backend import (HostBackend, default_backend,
                                         default_nb_workers)
from lz4_tpu_torch.block.batch import DICT_CAP, pack_blocks, to_device_batch
from lz4_tpu_torch.frame import batch as frame_batch
from lz4_tpu_torch.frame.format import FrameInfo, Preferences
from lz4_tpu_torch.frame.reader import FrameDecompressor, decompress_frame
from lz4_tpu_torch.frame.writer import (compress_frame, compress_legacy_frame,
                                        write_skippable_frame)
from lz4_tpu_torch.parallel import engine as eng
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.probes import (fullbench, gather_probe, host_frame,
                                  lane_probe, torture, walk_probe)
from lz4_tpu_torch.probes._common import floor as probe_floor
from lz4_tpu_torch.probes._common import measure
from lz4_tpu_torch.probes._timing import card as card_line
from lz4_tpu_torch.probes._timing import (cuda_ms, cuda_ms_back_to_back,
                                          cuda_ms_flushed, timed_runs)
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_hash_walk,
                                         gen_slot_words, gen_text)
from lz4_tpu_torch.utils.realcorpus import describe, real_corpus
from lz4_tpu_torch.xxh32 import xxh32_batch
from lz4_tpu_torch.xxh64 import XXH64State

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BLOCK = 65536
CORPUS = 48 << 20
PLAIN_ROWS = 8
KERNELS = {"B1": encode_cuda, "B2": decode_cuda, "B3": decode_wave,
           "B4": encode_wave, "B5": encode_hc, "B6": xxh32_device}
HC_PLAIN_ROWS = 2
EXAMPLES = ("simple_buffer", "file_compress", "block_streaming_double_buffer",
            "block_streaming_ring_buffer", "block_streaming_line_by_line",
            "streaming_hc_ring_buffer", "dictionary_random_access",
            "frame_compress", "bench_functions", "sharded_batch",
            "turbo_wave_mode")


def log(*a):
    print(*a, flush=True)


def host_ms(fn):
    t0 = time.perf_counter()
    r = fn()
    return (time.perf_counter() - t0) * 1e3, r


def stage(steps, name, fn):
    """Run fn, wait for the device, and record its host-clock ms."""
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    steps[name] = (time.perf_counter() - t0) * 1e3
    return r


def one_c_call(fn):
    """Host ms of fn() with the native batch calls kept to one span."""
    rows = native.SPAN_ROWS
    native.SPAN_ROWS = 1 << 30
    try:
        return host_ms(fn)
    finally:
        native.SPAN_ROWS = rows


def b1_resources() -> dict:
    """B1's four kernels (nvcc's report), each with its dynamic shared
    memory and threads from the library: solo and on device tables,
    without and with a history."""
    lib = ctypes.CDLL(_build.library_path("encode_serial"))
    solo, tables = (lib.lz4t_encode_serial_threads(k) for k in (1, 0))
    return {"kernels": kernel_resources("encode_serial", {
        "solo": ("encode_solo_kernelILb0", lib.lz4t_encode_serial_smem(0),
                 solo),
        "solo dict": ("encode_solo_kernelILb1",
                      lib.lz4t_encode_serial_smem(1), solo),
        "tables": ("encode_kernelILb0", 0, tables),
        "tables dict": ("encode_kernelILb1", 0, tables)})}


def b5_resources() -> dict:
    """B5's registers per thread (nvcc's report) and the dynamic shared
    memory of each CTA (the kernel's own figure)."""
    lib = ctypes.CDLL(_build.library_path("encode_hc"))
    regs = re.findall(r"Used (\d+) registers", _build.build_log("encode_hc"))
    return {"registers": int(regs[0]) if regs else None,
            "smem_bytes": int(lib.lz4t_encode_hc_smem())}


def b4_resources() -> dict:
    """B4's registers per thread (nvcc's report), and the dynamic shared
    memory and threads of each CTA at the max_dist path's hash_bits (the
    kernel's own figures)."""
    lib = ctypes.CDLL(_build.library_path("encode_wave"))
    regs = re.findall(r"Used (\d+) registers", _build.build_log("encode_wave"))
    return {"registers": int(regs[0]) if regs else None,
            "smem_bytes": int(lib.lz4t_encode_wave_smem(encode_wave.HASH_BITS)),
            "threads": int(lib.lz4t_encode_wave_threads())}


def ptxas_entries(name: str) -> list[dict]:
    """Per kernel entry of a built source (nvcc's report, in order):
    registers, spill stores and static shared memory."""
    out, cur = [], None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cur["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def kernel_resources(name: str, kinds: dict) -> dict:
    """Per kernel entry of source `name`, named by the first key of
    `kinds` whose pattern its mangled name holds: registers, spill
    stores and static shared memory (nvcc's report), with the dynamic
    shared memory and threads that `kinds` gives for it."""
    res = {}
    for e in ptxas_entries(name):
        for kind, (pattern, dyn_smem, threads) in kinds.items():
            if pattern in e["entry"]:
                res[kind] = {"registers": e.get("registers"),
                             "spill_stores": e.get("spill_stores"),
                             "static_smem": e.get("static_smem"),
                             "dynamic_smem": dyn_smem, "threads": threads}
                break
    return res


def b2_resources(per_call: int) -> dict:
    """B2's kernel at every row width (the launcher's dynamic shared
    memory and threads), with the launches that one wrapper call made."""
    lib = ctypes.CDLL(_build.library_path("decode_serial"))
    return {"kernels": kernel_resources("decode_serial", {
        "decode": ("decode_serial_kernel", lib.lz4t_decode_serial_smem(),
                   lib.lz4t_decode_serial_threads())}),
        "launches_per_call": per_call}


def b3_resources(per_call: int) -> dict:
    """B3's two instantiations: up to 64 pieces (tile and sources in
    shared memory), more (output and sources in global memory), with the
    launches that one wrapper call made."""
    lib = ctypes.CDLL(_build.library_path("decode_wave"))
    return {"kernels": kernel_resources("decode_wave", {
        "tile (<= 64 pieces)": ("ILb1E", lib.lz4t_decode_wave_smem(64),
                                lib.lz4t_decode_wave_threads(64)),
        "global (> 64 pieces)": ("ILb0E", lib.lz4t_decode_wave_smem(128),
                                 lib.lz4t_decode_wave_threads(128))}),
        "launches_per_call": per_call}


def b6_resources(B: int) -> dict:
    """B6's kernel (nvcc's report; the launcher's threads and dynamic
    shared memory) and its grid over the main path's B rows."""
    lib = ctypes.CDLL(_build.library_path("xxh32"))
    return {"kernels": kernel_resources("xxh32", {
        "ring": ("xxh32_kernel", lib.lz4t_xxh32_smem(),
                 lib.lz4t_xxh32_threads())}),
        "grid": lib.lz4t_xxh32_grid(B),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count}


def reset_launches():
    for mod in KERNELS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {k: mod.launches for k, mod in KERNELS.items()}


# ------------------------------------------------------------ comparisons

def compare_encode(gpu, plain, rows=None):
    """Kernel vs plain (each on its own device): identical out[:csize],
    csizes and trailing. Returns the max abs difference (0)."""
    go, gc, gt = (x.cpu() for x in gpu)
    po, pc, pt = plain
    if rows is not None:
        go, gc, gt = go[rows], gc[rows], gt[rows]
    if not (torch.equal(gc, pc) and torch.equal(gt, pt)):
        bad = (gc != pc).nonzero().flatten().tolist()
        raise AssertionError(f"B1 csizes/trailing differ at rows {bad[:8]}")
    err = 0
    for i, n in enumerate(pc.tolist()):
        d = (go[i, :n].int() - po[i, :n].int()).abs()
        err = max(err, int(d.max()) if n else 0)
    if err:
        raise AssertionError(f"B1 output bytes differ (max abs {err})")
    return err


def compare_decode(gpu, plain):
    go, gl, ge = (x.cpu() for x in gpu)
    po, pl, pe = plain
    if not (torch.equal(ge, pe) and torch.equal(gl, pl)):
        bad = ((ge != pe) | (gl != pl)).nonzero().flatten().tolist()
        raise AssertionError(f"B2 err/olen differ at rows {bad[:8]}")
    err = 0
    for i, n in enumerate(pl.tolist()):
        if not pe[i] and n:
            d = (go[i, :n].int() - po[i, :n].int()).abs()
            err = max(err, int(d.max()))
    if err:
        raise AssertionError(f"B2 output bytes differ (max abs {err})")
    return err


def encode_case(blocks, prefixes=None, cap=BLOCK, **kw):
    arrays = pack_blocks(blocks, prefixes, cap=cap,
                         with_dict=prefixes is not None)
    gpu = encode_cuda.encode_blocks(*to_device_batch(*arrays, device="cuda"),
                                    cap_n=cap, **kw)
    torch.cuda.synchronize()
    plain = encode_cuda.encode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_n=cap, **kw)
    err = compare_encode(gpu, plain)
    out, cs, _ = (x.cpu() for x in gpu)
    return err, [out[i, : cs[i]].numpy().tobytes() for i in range(len(blocks))]


def decode_case(streams, prefixes=None, cap_out=BLOCK, loose=False):
    cap_in = max(16, max(len(s) for s in streams))
    arrays = pack_blocks(streams, prefixes, cap=cap_in,
                         with_dict=prefixes is not None)
    gpu = decode_cuda.decode_blocks(*to_device_batch(*arrays, device="cuda"),
                                    cap_out=cap_out, loose=loose)
    torch.cuda.synchronize()
    plain = decode_cuda.decode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_out=cap_out,
        loose=loose)
    return compare_decode(gpu, plain), plain


def mutations(streams, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cc = bytearray(streams[k % len(streams)])
        mode = rng.integers(0, 3)
        if mode == 0:
            cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        elif mode == 1:
            cc = cc[: rng.integers(1, len(cc))]
        else:
            for _ in range(6):
                cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        out.append(bytes(cc))
    return out


def wave_arenas(streams, NP, hist_len=0):
    """The splitter's arenas of `streams` (each must be accepted)."""
    arenas = np.zeros((len(streams), NP, decode_wave.WCAP), np.uint8)
    out_lens = np.zeros(len(streams), np.int32)
    for i, c in enumerate(streams):
        r = native.blockcodec.wave_split(c, max_pieces=NP, out_cap=NP * 1024,
                                         hist_len=hist_len)
        if r is None:
            raise AssertionError(f"splitter rejected stream {i}")
        arenas[i, : r[0].shape[0]] = r[0]
        out_lens[i] = r[1]
    return arenas, out_lens


def arena_bytes_read(arenas, out_lens) -> int:
    """Arena bytes B3's parse reads: each live piece's slot up to the end
    of its sequences (the rest of the 1088-byte slot is padding it never
    reads). The parse of every piece at once, one sequence per step."""
    B, NP, W = arenas.shape
    flat = arenas.reshape(-1)
    o_end = np.clip(np.repeat(out_lens.astype(np.int64), NP)
                    - np.tile(np.arange(NP), B) * decode_wave.WOUT,
                    0, decode_wave.WOUT)
    c = np.zeros(B * NP, np.int64)
    o = np.zeros(B * NP, np.int64)
    act = np.nonzero(o_end > 0)[0]
    while act.size:
        ca, oa, base = c[act], o[act], act * W

        def rd(q):
            return np.where(q < W, flat[base + np.minimum(q, W - 1)],
                            0).astype(np.int64)
        tok = rd(ca)
        ca += 1
        lit, mn = tok >> 4, tok & 15
        ext = lit == 15
        lit += np.where(ext, rd(ca), 0)
        ca += ext + lit
        oa += lit
        ca += 2 * (mn > 0)
        ext = mn == 15
        mlen = mn + np.where(ext, rd(ca), 0)
        ca += ext
        oa += mlen
        c[act], o[act] = ca, oa
        act = act[(oa < o_end[act]) & (ca < W)]
    return int(np.minimum(c, W).sum())


def compare_wave_decode(gpu, plain, out_lens):
    gpu = gpu.cpu()
    err = 0
    for i, n in enumerate(out_lens.tolist()):
        if n:
            d = (gpu[i, :n].int() - plain[i, :n].int()).abs()
            err = max(err, int(d.max()))
    if err:
        raise AssertionError(f"B3 output bytes differ (max abs {err})")
    return err


def wave_decode_case(streams, NP, hist=None):
    """B3 vs plain on the arenas of `streams`; hist is a 64 KB history
    shared by every stream. Returns (max abs error, decoded rows)."""
    arenas, out_lens = wave_arenas(streams, NP,
                                   0 if hist is None else 65536)
    a, n = torch.from_numpy(arenas), torch.from_numpy(out_lens)
    h = None
    if hist is not None:
        h = torch.from_numpy(np.tile(np.frombuffer(hist, np.uint8),
                                     (len(streams), 1)))
    gpu = decode_wave.wave_decode(a.cuda(), n.cuda(),
                                  None if h is None else h.cuda())
    torch.cuda.synchronize()
    plain = decode_wave.wave_decode_plain(a, n, h)
    err = compare_wave_decode(gpu, plain, out_lens)
    return err, [plain[i, :k].numpy().tobytes()
                 for i, k in enumerate(out_lens.tolist())]


def find_matches_case(blocks, *, max_dist, hash_bits, hist=None,
                      hlen=None):
    """B4 vs plain decisions, exact. Returns the max abs difference."""
    n_rows = encode_wave.rows_for(max(len(b) for b in blocks))
    inp, lens = (torch.from_numpy(a)
                 for a in encode_wave.pack_input(blocks, n_rows))
    args = (inp, lens) if hist is None else (inp, lens, hist, hlen)
    gpu = encode_wave.find_matches(*(t.cuda() for t in args),
                                   max_dist=max_dist,
                                   hash_bits=hash_bits).cpu()
    plain = encode_wave.find_matches_plain(*args, max_dist=max_dist,
                                           hash_bits=hash_bits)
    if not torch.equal(gpu, plain):
        bad = (gpu != plain).nonzero()[:4].tolist()
        raise AssertionError(f"B4 decisions differ at {bad} (max_dist "
                             f"{max_dist}, hash_bits {hash_bits})")
    return 0


# ----------------------------------------------------------------- phases

def phase_kernels_vs_plain():
    rng = np.random.default_rng(2026)
    small = [gen_text(8000, seed=1), gen_buffer(8000, 0.7, seed=2),
             b"\x00" * 8000, rng.bytes(8000), b"Q", b"",
             gen_buffer(3000, 0.9, seed=3)]
    blocks = small + [gen_text(BLOCK, seed=4)]
    enc_err = 0
    streams = {}
    for accel in (1, 8, 65537):
        e, streams[accel] = encode_case(blocks, acceleration=accel)
        enc_err = max(enc_err, e)
        log(f"B1 == plain: {len(blocks)} blocks, acceleration {accel}")
    e, _ = encode_case(blocks, max_dist=2000)
    enc_err = max(enc_err, e)
    log("B1 == plain: max_dist=2000")
    hist = gen_text(90000, seed=5)
    dblocks = [gen_text(8000, seed=6), hist[-7000:-2000] + b"new" * 900,
               gen_buffer(5000, 0.6, seed=7), b"xyz", b""]
    prefixes = [hist, hist[-3000:], hist[-40000:], hist, None]
    e, dstreams = encode_case(dblocks, prefixes)
    enc_err = max(enc_err, e)
    e, _ = encode_case(dblocks, prefixes, acceleration=65537)
    enc_err = max(enc_err, e)
    log("B1 == plain: dict mode, full, partial and empty history, "
        "acceleration 1 and 65537")
    # probes of one lockstep scan window sharing hash slots
    coll = [gen_hash_walk(16384, seed=13), gen_slot_words(16384, seed=14),
            gen_slot_words(5000, pool=8, seed=15)]
    for accel in (1, 4, 8, 65537):
        e, _ = encode_case(coll, cap=16384, acceleration=accel)
        enc_err = max(enc_err, e)
    e, _ = encode_case(coll, [gen_hash_walk(20000, seed=16), None,
                              hist[-9000:]], cap=16384, acceleration=4)
    enc_err = max(enc_err, e)
    log("B1 == plain: hash-collision blocks, acceleration 1/4/8/65537, "
        "no-dict and dict")
    # more than 64 blocks in one call: a block's bytes do not depend on
    # its place in the batch
    many = [gen_text(1000 + 37 * i, seed=100 + i) if i % 3 else
            gen_buffer(4096, 0.5, seed=i) for i in range(80)]
    e, fwd = encode_case(many, cap=4096)
    enc_err = max(enc_err, e)
    e, rev = encode_case(many[::-1], cap=4096)
    enc_err = max(enc_err, e)
    if rev[::-1] != fwd:
        raise AssertionError("B1 output depends on a block's place")
    log("B1 == plain: 80 blocks in one call, forward and reversed")
    # rows that are not whole 32-bit words (byte reads)
    e, _ = encode_case(small, cap=8003)
    enc_err = max(enc_err, e)
    e, _ = encode_case(dblocks, prefixes, cap=8003, acceleration=2)
    enc_err = max(enc_err, e)
    log("B1 == plain: cap_n 8003, no-dict and dict")

    dec_err = 0
    for accel, ss in streams.items():
        e, (_, olen, err) = decode_case(ss)
        if err.any() or olen.tolist() != [len(b) for b in blocks]:
            raise AssertionError(f"B2 failed on valid streams (accel {accel})")
        dec_err = max(dec_err, e)
    e, (_, olen, err) = decode_case(dstreams, prefixes)
    if err.any() or olen.tolist() != [len(b) for b in dblocks]:
        raise AssertionError("B2 failed on valid dict streams")
    dec_err = max(dec_err, e)
    bad = mutations(streams[1][:4] + streams[8][6:7], 40, seed=11)
    e, (_, _, err) = decode_case(bad)
    dec_err = max(dec_err, e)
    log(f"B2 == plain: 40 mutated/truncated streams, {int(err.sum())} errors")
    piece = b"\x44abcd\x04\x00\x00"      # ends right after a match
    e, (out, olen, err) = decode_case([piece] + bad[:8], loose=True)
    if err[0] or out[0, : olen[0]].numpy().tobytes() != b"abcdabcdabcd":
        raise AssertionError("B2 loose piece failed")
    dec_err = max(dec_err, e)
    log("B2 == plain: valid, dict, mutated and loose streams")
    # the same cases in rows wider than 64 KB (the 4 MB route's widths)
    for ss, pre, loose in ((streams[1], None, False), (dstreams, prefixes,
                                                       False),
                           (bad, None, False), ([piece] + bad[:8], None,
                                                True)):
        e, _ = decode_case(ss, pre, cap_out=70000, loose=loose)
        dec_err = max(dec_err, e)
    log("B2 == plain with cap_out 70000: valid, dict, mutated and loose "
        "streams")

    # B3 on the splitter's arenas: B1 streams, host C HC streams (long
    # matches, far offsets), 1-piece streams, NP 4/16/64, a 64 KB history
    bc = native.blockcodec
    w_err = 0
    live = [c for c, b in zip(streams[1], blocks) if b]
    e, out = wave_decode_case(live, 64)
    if out != [b for b in blocks if b]:
        raise AssertionError("B3 failed on B1 streams")
    w_err = max(w_err, e)
    text = gen_text(3 * BLOCK, seed=8)
    hc_src = [text[:BLOCK], (b"0123456789abcdef" * 4096)[:BLOCK],
              rng.bytes(3000) * 20, b"\xaa" * 60000]
    for NP, n in ((4, 4096), (16, 16384), (64, BLOCK)):
        srcs = [s[:n] for s in hc_src] + [gen_buffer(n, 0.8, seed=NP)]
        ss = [bc.compress_hc(x, 9) for x in srcs] + \
            [bc.compress(x) for x in srcs]
        e, out = wave_decode_case(ss, NP)
        if out != srcs * 2:
            raise AssertionError(f"B3 failed at NP {NP}")
        w_err = max(w_err, e)
    one = [gen_text(k, seed=k) for k in (1, 13, 200, 1024)]
    e, out = wave_decode_case([bc.compress(x) for x in one], 4)
    if out != one:
        raise AssertionError("B3 failed on 1-piece streams")
    w_err = max(w_err, e)
    hist = text[BLOCK: 2 * BLOCK]
    ring_src = [text[2 * BLOCK:], text[BLOCK + 100: BLOCK + 30000],
                gen_buffer(40000, 0.7, seed=9)]
    e, out = wave_decode_case([bc.compress(x, dict_prefix=hist)
                               for x in ring_src], 64, hist=hist)
    if out != ring_src:
        raise AssertionError("B3 failed with a 64 KB history")
    w_err = max(w_err, e)
    log("B3 == plain: B1, HC and 1-piece streams, NP 4/16/64, "
        "64 KB history")
    # 128 pieces: the output in global memory, the sources in scratch
    big = [gen_text(2 * BLOCK, seed=17), b"0123456789abcdef" * 8192,
           rng.bytes(5000) * 26, gen_buffer(100000, 0.8, seed=18)]
    ss = [bc.compress(x) for x in big] + [bc.compress_hc(big[0], 9)]
    e, out = wave_decode_case(ss, 128)
    if out != big + big[:1]:
        raise AssertionError("B3 failed at NP 128")
    w_err = max(w_err, e)
    # garbage in rows 0 and 2 stays inside them: rows 1 and 3 stay exact
    for NP in (64, 128):
        arenas, out_lens = wave_arenas(
            [bc.compress(x[: NP * 1024]) for x in big], NP)
        for i in (0, 2):
            for _ in range(60):
                arenas[i, rng.integers(0, NP), rng.integers(0, 1088)] = \
                    rng.integers(0, 256)
        a, n = torch.from_numpy(arenas), torch.from_numpy(out_lens)
        gpu = decode_wave.wave_decode(a.cuda(), n.cuda())
        torch.cuda.synchronize()
        plain = decode_wave.wave_decode_plain(a, n)
        w_err = max(w_err, compare_wave_decode(gpu[1::2], plain[1::2],
                                               out_lens[1::2]))
    log("B3 == plain: NP 128 (output in global memory); garbage arenas at "
        "NP 64 and 128 leave the other rows exact")

    # B4 decisions: tiny, all-zero and random blocks, a 4-value byte pool
    # (equal hashes in one warp step), lengths of every residue mod 4,
    # runs over 16 KB (the force-end), no-dict and linked
    wblocks = [b"Q", b"abc" * 5, bytes(13), b"\x00" * 8000, rng.bytes(6001),
               gen_text(20002, seed=10), gen_buffer(9003, 0.8, seed=11),
               bytes(rng.integers(0, 4, 9000, dtype=np.uint8)),
               b"\x00" * 40000, b"abc" * 13334]
    n_rows = encode_wave.rows_for(max(len(b) for b in wblocks))
    htext = np.frombuffer(gen_text(70000, seed=12), np.uint8)
    for hb in (9, 10, 15):
        for md in ((1024, 2048, 65535) if hb < 15 else (2048, 65534)):
            find_matches_case(wblocks, max_dist=md, hash_bits=hb)
            wr = encode_wave.history_rows(md, n_rows)
            hist_t = torch.from_numpy(np.tile(htext[-wr * 4:],
                                              (len(wblocks), 1)))
            for hl in (wr * 4, 300):        # full and partial history
                hlen = torch.full((len(wblocks),), hl, dtype=torch.int32)
                find_matches_case(wblocks, max_dist=md, hash_bits=hb,
                                  hist=hist_t, hlen=hlen)
    log("B4 == plain: hash_bits 9/10/15, max_dist 1024/2048/65534/65535, "
        "no-dict and linked (full and partial history), runs over 16 KB")
    return enc_err, dec_err, w_err, 0


def phase_main_path(be):
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    B = len(blocks)
    log(f"main path: {describe(data)}, {B} blocks of {BLOCK}")
    fallbacks = be.host_fallbacks
    reset_launches()
    comp = be.compress_batch(blocks, level=1)
    on_compress = read_launches()
    back = be.decompress_batch(comp, [BLOCK] * B)
    launches = read_launches()
    on_decompress = {k: launches[k] - on_compress[k] for k in launches}
    if back != blocks:
        raise AssertionError("main path round trip differs from the source")
    if launches["B1"] < 1 or on_decompress["B3"] < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if on_decompress["B2"] or be.host_fallbacks != fallbacks:
        raise AssertionError(
            f"decompress left the wave tier: {on_decompress}, host "
            f"fallbacks {be.host_fallbacks - fallbacks}")
    csum = sum(len(c) for c in comp)
    log(f"main path round trip ok: ratio {len(data) / csum:.4f}, "
        f"launches {launches} (decompress: {on_decompress}, host "
        f"fallbacks 0)")

    # end to end through TorchBackend (host packing and copies included)
    enc_ms = cuda_ms(lambda: be.compress_batch(blocks, level=1), runs=3)
    dec_ms = cuda_ms(lambda: be.decompress_batch(comp, [BLOCK] * B),
                     runs=3)
    mb = len(data) / 1e6
    # the same call with the wave tier switched off (B2), for comparison
    be.wave_decode = False
    reset_launches()
    if be.decompress_batch(comp, [BLOCK] * B) != blocks:
        raise AssertionError("decompress with wave_decode off differs")
    b2_launches = read_launches()
    if b2_launches["B2"] < 1 or b2_launches["B3"]:
        raise AssertionError(f"wave_decode off skipped B2: {b2_launches}")
    b2_ms = cuda_ms(lambda: be.decompress_batch(comp, [BLOCK] * B), runs=3)
    be.wave_decode = True
    log(f"TorchBackend compress {mb / enc_ms * 1e3:.1f} MB/s "
        f"({enc_ms:.3f} ms), decompress (wave tier) "
        f"{mb / dec_ms * 1e3:.1f} MB/s ({dec_ms:.3f} ms), ratio "
        f"{len(data) / csum:.4f}; decompress with wave_decode off (B2) "
        f"{mb / b2_ms * 1e3:.1f} MB/s ({b2_ms:.3f} ms)")

    # where TorchBackend's time goes: the same steps, one at a time
    steps = {}
    arrays = stage(steps, "pack", lambda: pack_blocks(blocks, cap=BLOCK))
    src, lens, _, _ = stage(steps, "h2d", lambda: to_device_batch(
        *arrays, device="cuda"))
    enc = stage(steps, "B1", lambda: encode_cuda.encode_blocks(
        src, lens, cap_n=BLOCK))
    host = stage(steps, "d2h", lambda: (enc[0].cpu().numpy(),
                                        enc[1].cpu().tolist()))
    stage(steps, "to_bytes", lambda: [host[0][i, : host[1][i]].tobytes()
                                      for i in range(B)])
    log("compress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    steps = {}
    arenas, out_lens = stage(steps, "split", lambda: (
        native.blockcodec.wave_split_batch(comp, max_pieces=64,
                                           out_caps=[BLOCK] * B)))
    a_h, n_h = stage(steps, "pack", lambda: (torch.from_numpy(arenas),
                                             torch.from_numpy(out_lens)))
    a_d, n_d = stage(steps, "h2d", lambda: (a_h.cuda(), n_h.cuda()))
    wout = stage(steps, "B3", lambda: decode_wave.wave_decode(a_d, n_d))
    host = stage(steps, "d2h", lambda: wout.cpu().numpy())
    stage(steps, "to_bytes", lambda: [host[i, : out_lens[i]].tobytes()
                                      for i in range(B)])
    log("decompress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    one, _ = one_c_call(lambda: native.blockcodec.wave_split_batch(
        comp, max_pieces=64, out_caps=[BLOCK] * B))
    log(f"split as one C call (no row spans): {one:.3f} ms, against "
        f"{steps['split']:.3f} ms over {len(native._spans(B))} spans")

    # the kernels alone on the main path's device-resident batches
    gpu_enc = encode_cuda.encode_blocks(src, lens, cap_n=BLOCK)
    k_enc = cuda_ms(lambda: encode_cuda.encode_blocks(src, lens, cap_n=BLOCK))
    comp_t, clens_t, _, _ = to_device_batch(*pack_blocks(
        comp, cap=max(len(c) for c in comp)), device="cuda")
    k_dec = cuda_ms(lambda: decode_cuda.decode_blocks(comp_t, clens_t,
                                                      cap_out=BLOCK))
    k_wave = cuda_ms(lambda: decode_wave.wave_decode(a_d, n_d))
    # one call of each decoder's wrapper, counted: its launches per call
    reset_launches()
    gpu_dec = decode_cuda.decode_blocks(comp_t, clens_t, cap_out=BLOCK)
    gpu_wave = decode_wave.wave_decode(a_d, n_d)
    per_call = read_launches()
    log(f"kernel B1 {k_enc:.3f} ms ({mb / k_enc * 1e3:.1f} MB/s), "
        f"kernel B2 {k_dec:.3f} ms ({mb / k_dec * 1e3:.1f} MB/s), "
        f"kernel B3 {k_wave:.3f} ms ({mb / k_wave * 1e3:.1f} MB/s) "
        f"on {B} blocks")

    # plain versions on rows of the same batch
    rows = list(range(0, B, B // 64))[:64]
    cpu = [t.cpu() for t in (src, lens)]
    plain_enc = encode_cuda.encode_blocks_plain(cpu[0][rows], cpu[1][rows],
                                                cap_n=BLOCK)
    enc_err = compare_encode(gpu_enc, plain_enc, rows)
    cpu_out, cpu_cs = comp_t.cpu(), clens_t.cpu()
    plain_dec = decode_cuda.decode_blocks_plain(cpu_out, cpu_cs,
                                                cap_out=BLOCK)
    dec_err = compare_decode(gpu_dec, plain_dec)
    plain_wave = decode_wave.wave_decode_plain(a_h[rows], n_h[rows])
    wave_err = compare_wave_decode(gpu_wave[rows], plain_wave,
                                   n_h[rows])
    log(f"B1 == plain and B3 == plain on {len(rows)} main-path rows; "
        f"B2 == plain on all {B} rows")
    # B1 at a host call's 64 blocks (those rows, one call), against the
    # 768-block call: each with the path its plan takes
    src64, lens64 = src[rows].contiguous(), lens[rows].contiguous()
    s0 = encode_cuda.smem_launches
    enc64_err = compare_encode(
        encode_cuda.encode_blocks(src64, lens64, cap_n=BLOCK), plain_enc)
    k_enc64 = cuda_ms(lambda: encode_cuda.encode_blocks(src64, lens64,
                                                        cap_n=BLOCK))
    path64, path_all = (("solo" if encode_cuda.plan(n)[0] else "tables")
                        for n in (len(rows), B))
    if encode_cuda.smem_launches == s0 or path64 != "solo":
        raise AssertionError(f"B1 at {len(rows)} blocks left the solo path")
    log(f"kernel B1 {k_enc64:.3f} ms on {len(rows)} of those blocks "
        f"({path64}; == plain), {k_enc:.3f} ms on {B} ({path_all})")
    # the same 64 blocks each with the 64 KB before it as its history (the
    # first with none), as a linked frame's next blocks come: the dict
    # solo path's window, history slots taking block bytes as the anchor
    # passes them
    prev = torch.tensor([r - 1 for r in rows], device=src.device)
    hist64 = src[prev.clamp(min=0)].contiguous()
    hlens64 = torch.where(prev >= 0, BLOCK, 0).to(torch.int32)
    plain_dict = encode_cuda.encode_blocks_plain(
        cpu[0][rows], cpu[1][rows], hist64.cpu(), hlens64.cpu(), cap_n=BLOCK)
    s0, d0 = encode_cuda.smem_launches, encode_cuda.dict_launches
    enc64d_err = compare_encode(encode_cuda.encode_blocks(
        src64, lens64, hist64, hlens64, cap_n=BLOCK), plain_dict)
    if (encode_cuda.smem_launches, encode_cuda.dict_launches) != (s0 + 1,
                                                                   d0 + 1):
        raise AssertionError(f"B1 at {len(rows)} blocks with their history "
                             "left the dict solo path")
    k_enc64d = cuda_ms(lambda: encode_cuda.encode_blocks(
        src64, lens64, hist64, hlens64, cap_n=BLOCK))
    log(f"kernel B1 {k_enc64d:.3f} ms on those {len(rows)} blocks with "
        f"their history (solo dict; == plain)")
    r8 = rows[:PLAIN_ROWS]
    p_enc, _ = host_ms(lambda: encode_cuda.encode_blocks_plain(
        cpu[0][r8], cpu[1][r8], cap_n=BLOCK))
    p_dec, _ = host_ms(lambda: decode_cuda.decode_blocks_plain(
        cpu_out[r8], cpu_cs[r8], cap_out=BLOCK))
    p_wave, _ = host_ms(lambda: decode_wave.wave_decode_plain(
        a_h[r8], n_h[r8]))
    log(f"plain B1 {p_enc:.1f} ms, plain B2 {p_dec:.1f} ms, plain B3 "
        f"{p_wave:.1f} ms on {PLAIN_ROWS} blocks")

    enc_bytes = len(data) + csum + B * 12     # src + lens in; out + 2 ints
    dec_bytes = csum + B * 4 + len(data) + B * 8
    # B3 reads the used part of each piece slot and the lengths, and
    # writes the decoded bytes
    arena_read = arena_bytes_read(arenas, out_lens)
    wave_bytes = arena_read + B * 4 + int(out_lens.sum())
    log(f"B3 bound: {arena_read} arena bytes read of {arenas.nbytes} "
        f"allocated, {int(out_lens.sum())} bytes written")
    return {
        "launches": launches, "b2_launches": b2_launches,
        "b2_per_call": per_call["B2"], "b3_per_call": per_call["B3"],
        "enc_ms": k_enc, "dec_ms": k_dec,
        "wave_ms": k_wave, "plain_enc_ms": p_enc, "plain_dec_ms": p_dec,
        "plain_wave_ms": p_wave,
        "enc_bound_ms": enc_bytes / HBM_BYTES_PER_S * 1e3,
        "dec_bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3,
        "wave_bound_ms": wave_bytes / HBM_BYTES_PER_S * 1e3,
        "enc_err": max(enc_err, enc64_err, enc64d_err), "dec_err": dec_err,
        "wave_err": wave_err, "blocks": B, "enc64_ms": k_enc64,
        "enc64_dict_ms": k_enc64d,
        "enc_path": path_all, "enc64_path": path64,
    }


def phase_max_dist(be):
    """compress_batch(level=1, max_dist=2048): B4 plus the C emitter."""
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    B = len(blocks)
    reset_launches()
    comp = be.compress_batch(blocks, level=1, max_dist=2048)
    launches = read_launches()
    if launches["B4"] < 1:
        raise AssertionError(f"max_dist path skipped B4: {launches}")
    if be.decompress_batch(comp, [BLOCK] * B) != blocks:
        raise AssertionError("max_dist streams fail the wave decode")
    if HostBackend().decompress_batch(comp, [BLOCK] * B) != blocks:
        raise AssertionError("max_dist streams fail the host C decoder")
    csum = sum(len(c) for c in comp)
    mb = len(data) / 1e6
    e2e = cuda_ms(lambda: be.compress_batch(blocks, level=1, max_dist=2048),
                  runs=3)
    log(f"max_dist=2048 path ok: ratio {len(data) / csum:.4f}, compress "
        f"{mb / e2e * 1e3:.1f} MB/s ({e2e:.3f} ms), launches {launches}, "
        "round trip through the wave tier and the host C decoder")

    steps = {}
    n_rows = encode_wave.rows_for(BLOCK)
    inp, lens = stage(steps, "pack", lambda: encode_wave.pack_input(
        blocks, n_rows))
    inp_d, lens_d = stage(steps, "h2d", lambda: (
        torch.from_numpy(inp).cuda(), torch.from_numpy(lens).cuda()))
    dec = stage(steps, "B4", lambda: encode_wave.find_matches(
        inp_d, lens_d, max_dist=2048))
    dec_h = stage(steps, "d2h", lambda: dec.cpu().numpy())
    out = stage(steps, "emit", lambda: native.blockcodec.wave_emit_decisions(
        blocks, dec_h))
    if out != comp:
        raise AssertionError("max_dist steps differ from compress_batch")
    log("max_dist compress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    one, _ = one_c_call(lambda: native.blockcodec.wave_emit_decisions(
        blocks, dec_h))
    log(f"emit as one C call (no row spans): {one:.3f} ms, against "
        f"{steps['emit']:.3f} ms over {len(native._spans(B))} spans")

    k_ms = cuda_ms(lambda: encode_wave.find_matches(inp_d, lens_d,
                                                    max_dist=2048))
    rows = list(range(0, B, B // 64))[:64]
    inp_h, lens_h = torch.from_numpy(inp), torch.from_numpy(lens)
    plain = encode_wave.find_matches_plain(inp_h[rows], lens_h[rows],
                                           max_dist=2048)
    if not torch.equal(dec.cpu()[rows], plain):
        raise AssertionError("B4 != plain on main-path rows")
    r8 = rows[:PLAIN_ROWS]
    p_ms, _ = host_ms(lambda: encode_wave.find_matches_plain(
        inp_h[r8], lens_h[r8], max_dist=2048))
    log(f"kernel B4 {k_ms:.3f} ms ({mb / k_ms * 1e3:.1f} MB/s) on {B} "
        f"blocks; B4 == plain on {len(rows)} rows; plain B4 {p_ms:.1f} ms "
        f"on {PLAIN_ROWS} blocks")
    bound = (len(data) + B * 4 + dec.numel() * 4) / HBM_BYTES_PER_S * 1e3
    return {"launches": launches, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "err": 0}


def phase_frames(be):
    """16 MB frames through the sequential frame layer; returns them by
    kind ("linked", "independent")."""
    data = real_corpus(CORPUS)[: 16 << 20]
    written = {}
    for bsid, independent in ((7, False), (4, True)):
        before = read_launches()
        prefs = Preferences(frame_info=FrameInfo(
            block_size_id=bsid, block_independent=independent,
            block_checksum=True, content_checksum=True))
        t_c, frame = host_ms(lambda: compress_frame(data, prefs=prefs,
                                                    backend=be))
        t_d, back = host_ms(lambda: decompress_frame(frame, backend=be))
        if back != data:
            raise AssertionError(f"frame round trip failed (bsid {bsid})")
        after = read_launches()
        # 64 KB independent blocks decode on B3; 4 MB linked blocks on the
        # host (outputs over 256 KB, decode_dest "auto"), as in TpuBackend
        if independent:
            route_ok = after["B3"] > before["B3"]
        else:
            route_ok = after["B2"] == before["B2"] and \
                after["B3"] == before["B3"]
        if not (after["B1"] > before["B1"] and route_ok):
            raise AssertionError(f"frame path took a wrong route: {before} "
                                 f"-> {after}")
        kind = "independent" if independent else "linked"
        written[kind] = frame
        log(f"frame ok: 16 MB, {kind} "
            f"{FrameInfo(block_size_id=bsid).block_max_size >> 10} KB "
            f"blocks, ratio {len(data) / len(frame):.4f}, compress "
            f"{t_c:.1f} ms, decompress {t_d:.1f} ms (host clock, "
            f"checksums in C; decode on "
            f"{'B3' if independent else 'the host, B2 launches 0'})")
        if not independent:
            # decode_dest "device": each 4 MB block as linked pieces, B2
            # a wave (the reader hands the blocks over one at a time)
            calls = []
            big = be._decompress_big_batch
            be._decompress_big_batch = lambda b, m, d: (
                calls.append((b, m)), big(b, m, d))[1]
            be.decode_dest = "device"
            mid = read_launches()
            try:
                t_p, back = host_ms(lambda: decompress_frame(frame,
                                                             backend=be))
            finally:
                be.decode_dest = "auto"
                del be._decompress_big_batch
            launched = read_launches()["B2"] - mid["B2"]
            waves = sum(max(len(native.blockcodec.split_stream(
                c, out_cap=n)[1]) for c, n in zip(bs, ms))
                for bs, ms in calls)
            if back != data or not calls or launched != waves:
                raise AssertionError(
                    f"decode_dest 'device' skipped the piece route: "
                    f"{len(calls)} calls, B2 launches {launched}, waves "
                    f"{waves}")
            log(f"the same frame with decode_dest 'device' (piece route, "
                f"{len(calls)} calls, {waves} waves = B2 launches "
                f"{launched}): decompress {t_p:.1f} ms (host clock)")
            # one 4 MB block on B2 (whole row) against the plain version
            blk = native.blockcodec.compress(data[: 4 << 20])
            e, (_, olen, err) = decode_case([blk], cap_out=4 << 20)
            if e or err.any() or int(olen[0]) != 4 << 20:
                raise AssertionError("B2 on a 4 MB block differs from plain")
            log("B2 == plain on a 4 MB block (cap_out 4 MB)")
    return written


def phase_batch_frames(be):
    """128 streams x 384 KiB through the batch frame surfaces, linked and
    independent; the linked frames also through the sequential decoder
    (B2). Returns the linked frames."""
    data = real_corpus(CORPUS)
    size = 384 << 10
    datas = [data[i: i + size] for i in range(0, 128 * size, size)]
    mb = len(datas) * size / 1e6
    reset_launches()
    for independent in (False, True):
        seq = frame_batch.sequential_fallbacks
        t_c, frames = host_ms(lambda: frame_batch.compress_frames_wave(
            datas, block_independent=independent))
        t_d, back = host_ms(lambda: frame_batch.decompress_frames_wave(
            frames))
        if back != datas:
            raise AssertionError("batch frames round trip failed")
        if frame_batch.sequential_fallbacks != seq:
            raise AssertionError(
                f"{frame_batch.sequential_fallbacks - seq} batch frames "
                "left the wave tier")
        kind = "independent" if independent else "linked"
        csum = sum(len(f) for f in frames)
        log(f"batch frames ok: 128 x 384 KiB {kind}, ratio "
            f"{len(datas) * size / csum:.4f}, compress_frames_wave "
            f"{t_c:.1f} ms ({mb / t_c * 1e3:.1f} MB/s), "
            f"decompress_frames_wave {t_d:.1f} ms "
            f"({mb / t_d * 1e3:.1f} MB/s), sequential fallbacks 0")
        if not independent:
            t_s, seq_back = host_ms(lambda: [
                decompress_frame(f, backend=be) for f in frames])
            if seq_back != datas:
                raise AssertionError("sequential decode of batch frames "
                                     "failed")
            log(f"the same linked frames through decompress_frame: "
                f"{t_s:.1f} ms ({mb / t_s * 1e3:.1f} MB/s)")
            linked = frames
    launches = read_launches()
    for k in ("B2", "B3", "B4"):
        if launches[k] < 1:
            raise AssertionError(f"batch frame path skipped {k}: "
                                 f"{launches}")
    log(f"batch frame launches {launches}")
    return linked


def compare_hc(gpu, plain, what):
    """B5 vs plain: identical csizes, trailing and out[:csize]."""
    go, gc, gt = (x.cpu() for x in gpu)
    po, pc, pt = plain
    if not (torch.equal(gc, pc) and torch.equal(gt, pt)):
        bad = ((gc != pc) | (gt != pt)).nonzero().flatten().tolist()
        raise AssertionError(f"B5 csizes/trailing differ at rows {bad[:8]} "
                             f"({what})")
    for i, n in enumerate(pc.tolist()):
        if not torch.equal(go[i, :n], po[i, :n]):
            raise AssertionError(f"B5 output bytes differ in row {i} ({what})")


def phase_hc_xxh_vs_plain():
    """B5 at levels 3, 5, 9 with favor_dec_speed on and off, and B6 with
    seeds 0 and 2^32-1, each against its plain version."""
    rng = np.random.default_rng(2027)
    cap = 16384
    rows = [gen_text(cap, seed=21), b"\xab" * 9000, bytes(cap),
            b"abab" * 2000 + b"Q" + b"abab" * 1000, rng.bytes(6000),
            gen_text(200, seed=22), b"abcabcabcab", b"",
            gen_buffer(cap, 0.97, seed=23)]
    src, lens, _, _ = pack_blocks(rows, cap=cap)
    src_t, lens_t = torch.from_numpy(src), torch.from_numpy(lens)
    for level in (3, 5, 9):
        for favor in (False, True):
            kw = dict(cap_n=cap, level=level, favor_dec_speed=favor)
            gpu = encode_hc.encode_blocks_hc(src_t.cuda(), lens_t.cuda(), **kw)
            torch.cuda.synchronize()
            compare_hc(gpu, encode_hc.encode_blocks_hc_plain(src_t, lens_t,
                                                             **kw),
                       f"level {level}, favor {favor}")
    log(f"B5 == plain: {len(rows)} rows (text, RLE, zeros, periodic, "
        "random, short, under 13 bytes, empty), levels 3/5/9, "
        "favor_dec_speed off and on")

    xxh_err = 0
    for cap in (16, 4096, 65536):
        lens = [int(k) for k in rng.integers(0, cap + 1, 30)]
        lens += [0, 1, min(15, cap), cap - 1, cap]
        data, lens_a, _, _ = pack_blocks([rng.bytes(k) for k in lens],
                                         cap=cap)
        d, n = torch.from_numpy(data), torch.from_numpy(lens_a)
        for seed in (0, 0xFFFFFFFF):
            gpu = xxh32_device.xxh32_blocks(d.cuda(), n.cuda(), seed,
                                            cap=cap).cpu()
            plain = xxh32_device.xxh32_blocks_plain(d, n, seed, cap=cap)
            xxh_err = max(xxh_err, int((gpu - plain).abs().max()))
            if xxh_err:
                raise AssertionError(f"B6 differs from plain (cap {cap}, "
                                     f"seed {seed})")
    log("B6 == plain: rows of random lengths 0..cap (cap 16, 4096, "
        "65536), seeds 0 and 0xFFFFFFFF")
    return 0, xxh_err


def b6_vs_host(data, lens, seed):
    """B6 on the card against the host C XXH32 of each row; raises on a
    row that differs."""
    gpu = xxh32_device.xxh32_blocks(
        torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda(), seed,
        cap=data.shape[1]).cpu().numpy()
    want = xxh32_batch(data, lens, seed)
    bad = np.nonzero(gpu.astype(np.uint32) != want)[0].tolist()
    if bad:
        raise AssertionError(f"B6 differs from host XXH32 in rows {bad[:8]} "
                             f"(B {len(lens)}, cap {data.shape[1]}, seed "
                             f"{seed})")


def phase_xxh_host():
    """B6 against the host C XXH32 on rows of 1 MB and 4 MB (whose chain
    sets B6's time; the plain version is too slow there) and on B = 1, 7
    and 768 rows of 64 KB, ragged lengths on and around stage (2 KB) and
    stripe boundaries; and one 4 MB row's time."""
    rng = np.random.default_rng(2028)
    stage = xxh32_device.STAGE_BYTES
    for cap, lens in ((1 << 20, [1 << 20, (1 << 20) - 1, stage - 1, stage,
                                 stage + 1, 17, 0]),
                      (4 << 20, [4 << 20, (4 << 20) - 15,
                                 (4 << 20) - stage + 1]),
                      (4 << 20, [4 << 20])):
        data = rng.integers(0, 256, (len(lens), cap), dtype=np.uint8)
        for seed in (0, 0xDEADBEEF):
            b6_vs_host(data, np.array(lens, np.int32), seed)
    for B in (1, 7, 768):
        lens = rng.integers(0, BLOCK + 1, B).astype(np.int32)
        lens[: min(B, 5)] = [BLOCK, 15, 16, 17, stage][: min(B, 5)]
        data = rng.integers(0, 256, (B, BLOCK), dtype=np.uint8)
        for seed in (0, 1, 0xFFFFFFFF):
            b6_vs_host(data, lens, seed)
    big = torch.from_numpy(rng.integers(0, 256, (1, 4 << 20),
                                        dtype=np.uint8)).cuda()
    lens4 = torch.tensor([4 << 20], dtype=torch.int32, device="cuda")
    ms4 = cuda_ms(lambda: xxh32_device.xxh32_blocks(big, lens4, cap=4 << 20),
                  runs=3)
    log(f"B6 == host C XXH32: rows of 1 MB (B 7) and 4 MB (B 3 and 1), and "
        f"B 1, 7, 768 of 64 KB, ragged, seeds 0/1/0xDEADBEEF/0xFFFFFFFF; one "
        f"4 MB row {ms4:.4f} ms ({(4 << 20) // 16} rounds a lane)")
    return ms4


def phase_hc_path(be):
    """compress_batch(level=3 and 9) over the 48 MB corpus: one B5 launch
    each, byte-identical to the host C compress_hc, round-tripped."""
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    B = len(blocks)
    mb = len(data) / 1e6
    host = HostBackend()
    res = {}
    for level in (3, 9):
        hc0 = be.hc_encoded
        reset_launches()
        comp = be.compress_batch(blocks, level=level)
        launches = read_launches()
        if launches["B5"] != 1 or be.hc_encoded != hc0 + 1 or \
                sum(launches.values()) != 1:
            raise AssertionError(f"HC level {level} path did not run one B5 "
                                 f"launch: {launches}")
        t_host, want = host_ms(lambda: host.compress_batch(blocks,
                                                           level=level))
        bad = [i for i in range(B) if comp[i] != want[i]]
        if bad:
            raise AssertionError(f"B5 level {level} differs from C "
                                 f"compress_hc in blocks {bad[:8]}")
        if be.decompress_batch(comp, [BLOCK] * B) != blocks:
            raise AssertionError(f"HC level {level} round trip differs")
        csum = sum(len(c) for c in comp)
        e2e = cuda_ms(lambda: be.compress_batch(blocks, level=level), runs=2)
        log(f"HC level {level} path ok: {B} blocks byte-identical to C "
            f"compress_hc ({t_host:.1f} ms on the host), round trip ok, "
            f"ratio {len(data) / csum:.4f}, compress {mb / e2e * 1e3:.1f} "
            f"MB/s ({e2e:.3f} ms), launches {launches}")

        steps = {}
        src, lens, _, _ = stage(steps, "pack", lambda: pack_blocks(
            blocks, cap=BLOCK))
        src_d, lens_d, _, _ = stage(steps, "h2d", lambda: to_device_batch(
            src, lens, device="cuda"))
        out = stage(steps, "B5", lambda: encode_hc.encode_blocks_hc(
            src_d, lens_d, cap_n=BLOCK, level=level))
        host_out = stage(steps, "d2h", lambda: (out[0].cpu().numpy(),
                                                out[1].cpu().tolist()))
        stage(steps, "to_bytes", lambda: [
            host_out[0][i, : host_out[1][i]].tobytes() for i in range(B)])
        log(f"HC level {level} compress steps (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in steps.items()))
        c0 = encode_hc.cluster_launches
        k_ms = cuda_ms(lambda: encode_hc.encode_blocks_hc(
            src_d, lens_d, cap_n=BLOCK, level=level), runs=3)
        if encode_hc.cluster_launches != c0:
            raise AssertionError(f"B5 on {B} blocks made a cluster launch")
        # the CLI's call at -B4: 64 blocks, a 2-CTA cluster each where the
        # card holds 64 clusters; its bytes equal the 768-block call's
        n64, c64 = encode_hc.launches, encode_hc.cluster_launches
        width64, clusters = encode_hc.plan(64)
        ms64 = cuda_ms(lambda: encode_hc.encode_blocks_hc(
            src_d[:64], lens_d[:64], cap_n=BLOCK, level=level), runs=3)
        o64, cs64, tr64 = encode_hc.encode_blocks_hc(
            src_d[:64], lens_d[:64], cap_n=BLOCK, level=level)
        made = encode_hc.launches - n64
        wide = encode_hc.cluster_launches - c64
        if wide != (made if width64 == 2 else 0):
            raise AssertionError(f"B5 at 64 blocks: {wide} cluster launches "
                                 f"of {made} at width {width64}")
        compare_hc((o64, cs64, tr64), tuple(x[:64].cpu() for x in out),
                   f"64 blocks at width {width64}, level {level}")
        rows = list(range(0, B, B // HC_PLAIN_ROWS))[:HC_PLAIN_ROWS]
        src_c, lens_c = torch.from_numpy(src), torch.from_numpy(lens)
        p_ms, plain = host_ms(lambda: encode_hc.encode_blocks_hc_plain(
            src_c[rows], lens_c[rows], cap_n=BLOCK, level=level))
        compare_hc(tuple(x[rows] for x in out), plain,
                   f"main-path rows, level {level}")
        log(f"kernel B5 level {level}: {k_ms:.3f} ms ({mb / k_ms * 1e3:.1f} "
            f"MB/s) on {B} blocks; B5 == plain on {len(rows)} rows; plain "
            f"{p_ms:.1f} ms on {len(rows)} rows; 64 blocks at width "
            f"{width64} ({clusters} clusters): {ms64:.3f} ms, "
            f"{wide} of {made} launches cluster launches")
        nbytes = len(data) + B * 4 + csum + B * 8
        res[level] = {"launches": launches, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "err": 0, "plain_rows": len(rows), "ms_64": ms64,
                      "width_64": width64, "clusters": clusters}

    # B6 on the same device-resident batch (the bench's check, full size)
    lens_full = torch.full((B,), BLOCK, dtype=torch.int32, device="cuda")
    def x_run():
        return xxh32_device.xxh32_blocks(src_d, lens_full, cap=BLOCK)

    x_ms = cuda_ms(x_run, runs=10)
    x_b2b = cuda_ms_back_to_back(x_run)
    x_cold = cuda_ms_flushed(x_run)
    got = xxh32_device.xxh32_blocks(src_d, lens_full, cap=BLOCK).cpu()
    want = torch.tensor([native.xxh.xxh32(b) for b in blocks])
    if not torch.equal(got, want):
        raise AssertionError("B6 differs from host XXH32 on the main path")
    r8 = list(range(PLAIN_ROWS))
    p_ms, plain = host_ms(lambda: xxh32_device.xxh32_blocks_plain(
        src_c[r8], lens_c[r8], cap=BLOCK))
    err = int((got[r8] - plain).abs().max())
    if err:
        raise AssertionError("B6 differs from plain on main-path rows")
    b6 = b6_resources(B)
    log(f"kernel B6: {x_ms:.4f} ms a launch after a sync, {x_b2b:.4f} ms "
        f"back to back (mean of 20), {x_cold:.4f} ms with the L2 flushed, "
        f"on {B} blocks of {BLOCK} ({mb / x_ms * 1e3:.1f} MB/s), grid "
        f"{b6['grid']} CTAs on {b6['sms']} SMs; == host XXH32 on every "
        f"block, == plain on {PLAIN_ROWS} rows; plain {p_ms:.1f} ms on "
        f"{PLAIN_ROWS} rows")
    res["xxh"] = {"ms": x_ms, "ms_back_to_back": x_b2b,
                  "ms_l2_flushed": x_cold, "plain_ms": p_ms, "err": err,
                  "bound_ms": (len(data) + B * 12) / HBM_BYTES_PER_S * 1e3,
                  **b6}
    return res


def phase_level2(be):
    """compress_batch(level=2) over the 48 MB corpus: the sort/scan
    encoder as torch ops on the card (no kernel launch), its bytes equal
    to the same module's on the CPU on sampled rows, a dict batch and
    blocks over 64 KB, round-tripped through the host C decoder."""
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    B = len(blocks)
    mb = len(data) / 1e6
    host, cpu = HostBackend(), TorchBackend("cpu")
    d0 = be.device_hc_encoded
    reset_launches()
    comp = be.compress_batch(blocks, level=2)
    launches = read_launches()
    if sum(launches.values()) or be.device_hc_encoded != d0 + 1:
        raise AssertionError(f"level 2 left the sort/scan route: {launches}, "
                             f"device_hc_encoded {be.device_hc_encoded - d0}")
    if host.decompress_batch(comp, [BLOCK] * B) != blocks:
        raise AssertionError("level 2 streams fail the host C decoder")
    rows = list(range(0, B, B // 8))[:8]
    t_cpu, want = host_ms(lambda: cpu.compress_batch(
        [blocks[i] for i in rows], level=2))
    if [comp[i] for i in rows] != want:
        raise AssertionError("level 2 on the card differs from the CPU")
    # a dict batch (each block with the one before it as its dict) and
    # blocks over 64 KB (linked segments in dict mode, then merged)
    dblocks, prefixes = blocks[1:17], blocks[:16]
    got = be.compress_batch(dblocks, level=2, dict_prefixes=prefixes)
    if got != cpu.compress_batch(dblocks, level=2, dict_prefixes=prefixes) \
            or host.decompress_batch(got, [BLOCK] * 16,
                                     dict_prefixes=prefixes) != dblocks:
        raise AssertionError("level 2 dict batch differs or fails to decode")
    big = [data[: 300000], data[300000: 1 << 20]]
    got = be.compress_batch(big, level=2)
    if got != cpu.compress_batch(big, level=2) or \
            host.decompress_batch(got, [1 << 20] * 2) != big:
        raise AssertionError("level 2 blocks over 64 KB differ or fail")
    csum = sum(len(c) for c in comp)
    e2e = cuda_ms(lambda: be.compress_batch(blocks, level=2), runs=2)
    log(f"level 2 path ok: {B} blocks, ratio {len(data) / csum:.4f}, "
        f"compress {mb / e2e * 1e3:.1f} MB/s ({e2e:.3f} ms), launches "
        f"{launches}; == the CPU on {len(rows)} rows ({t_cpu:.1f} ms there), "
        "a 16-block dict batch and 300 KB / 748 KB blocks; host C decode ok")

    steps = {}
    src, lens, _, _ = stage(steps, "pack", lambda: pack_blocks(blocks,
                                                               cap=BLOCK))
    src_d, lens_d, _, _ = stage(steps, "h2d", lambda: to_device_batch(
        src, lens, device="cuda"))
    out = stage(steps, "sortscan", lambda: encode_sortscan.encode_blocks(
        src_d, lens_d, cap_n=BLOCK, has_dict=False, n_cand=8, lazy=True))
    host_out = stage(steps, "d2h", lambda: (out[0].cpu().numpy(),
                                            out[1].cpu().tolist()))
    stage(steps, "to_bytes", lambda: [
        host_out[0][i, : host_out[1][i]].tobytes() for i in range(B)])
    log("level 2 compress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    # the hop parse of one chunk of rows: pointer doubling and the loop
    R = encode_sortscan.chunk_rows(BLOCK, src_d.device)
    tabs = encode_sortscan._match_tables(
        src_d[:R].long(), lens_d[:R].long(),
        torch.zeros(min(R, B), dtype=torch.long, device="cuda"), d0=0,
        n_cand=8, lazy=True, lite=False)
    hops = {}
    for name, fn, runs in (("doubling", encode_sortscan._parse_hops, 2),
                           ("loop", encode_sortscan._parse_hops_loop, 1)):
        hops[name] = fn(tabs[0], tabs[1], d0=0, cap_n=BLOCK)
        hops[name + "_ms"] = cuda_ms(lambda: fn(tabs[0], tabs[1], d0=0,
                                                cap_n=BLOCK), runs=runs)
    if not torch.equal(hops["doubling"], hops["loop"]):
        raise AssertionError("hop parses disagree")
    tok = int((hops["doubling"] < BLOCK).sum())
    t_dbl, t_loop = hops["doubling_ms"], hops["loop_ms"]
    log(f"level 2 hop parse of one chunk ({min(R, B)} rows, {tok} tokens): "
        f"pointer doubling {t_dbl:.3f} ms, one gather per hop "
        f"{t_loop:.3f} ms")
    # one chunk's device memory, held to the budget it is sized by
    del tabs, hops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encode_sortscan.encode_blocks(src_d[:R], lens_d[:R], cap_n=BLOCK,
                                  has_dict=False, n_cand=8, lazy=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    budget = encode_sortscan.BUDGET["cuda"]
    log(f"level 2 chunk of {min(R, B)} rows: peak device memory "
        f"{peak / 2**30:.3f} GiB of its {budget / 2**30:.0f} GiB budget, "
        f"{peak / (min(R, B) * BLOCK * 8):.2f} int64 lanes a position "
        f"(sized by {encode_sortscan._LANES})")
    if peak > budget:
        raise AssertionError("a level 2 chunk exceeds its memory budget")


def phase_host_pool():
    """HostBackend(nb_workers=1) against default_nb_workers() workers:
    level 12 (the host-only HC tier) on a sample of the corpus, and the
    16 MB independent 4 MB-block frame's decode; bytes equal."""
    data = real_corpus(CORPUS)
    n = default_nb_workers()
    one, many = HostBackend(nb_workers=1), HostBackend(nb_workers=n)
    sample = [data[i: i + BLOCK] for i in range(0, 48 * BLOCK, BLOCK)]
    t1, c1 = host_ms(lambda: one.compress_batch(sample, level=12))
    tn, cn = host_ms(lambda: many.compress_batch(sample, level=12))
    if c1 != cn or many.decompress_batch(cn, [BLOCK] * len(sample)) \
            != sample:
        raise AssertionError("level 12 bytes depend on the worker count")
    frame = compress_frame(data[: 16 << 20], prefs=Preferences(
        frame_info=FrameInfo(block_size_id=7)), backend=many)
    d1, b1 = host_ms(lambda: decompress_frame(frame, backend=one))
    dn, bn = host_ms(lambda: decompress_frame(frame, backend=many))
    if not b1 == bn == data[: 16 << 20]:
        raise AssertionError("4 MB-block decode depends on the worker count")
    log(f"host pool ({os.cpu_count()} cores, default_nb_workers {n}): "
        f"level 12 on {len(sample)} x 64 KB {t1:.1f} ms with 1 worker, "
        f"{tn:.1f} ms with {n}; 16 MB -B7 frame decode {d1:.1f} ms with 1, "
        f"{dn:.1f} ms with {n} (host clock); bytes equal")
    return {"workers": n, "l12_1": t1, "l12_n": tn, "dec_1": d1,
            "dec_n": dn}


def phase_big_blocks(be):
    """The same four linked 4 MB blocks (each with the 64 KB before it
    as history) through the piece route (B2 a wave), B2 on whole 4 MB
    rows, and the host tier with 1 and N workers."""
    data = real_corpus(CORPUS)[: 16 << 20]
    MB4 = 4 << 20
    prefixes = [None] + [data[i - DICT_CAP: i] for i in range(MB4, 16 << 20,
                                                                MB4)]
    blocks = [native.blockcodec.compress(data[i: i + MB4], dict_prefix=d)
              for i, d in zip(range(0, 16 << 20, MB4), prefixes)]
    caps = [MB4] * 4
    want = [data[i: i + MB4] for i in range(0, 16 << 20, MB4)]
    splits = [native.blockcodec.split_stream(c, out_cap=MB4) for c in blocks]
    waves = max(len(s[1]) for s in splits)
    reset_launches()
    t_piece, got = host_ms(lambda: be._decompress_big_batch(blocks, caps,
                                                            prefixes))
    launches = read_launches()
    if got != want or launches["B2"] != waves:
        raise AssertionError(f"piece route: B2 launches {launches['B2']}, "
                             f"waves {waves}, bytes equal {got == want}")
    e2e_piece = cuda_ms(lambda: be._decompress_big_batch(blocks, caps,
                                                         prefixes), runs=3)
    # the waves alone, on device-resident pieces
    B = len(blocks)
    arenas, plens = eng.pack_pieces(splits)
    src0, lens0, hist, hlen = pack_blocks([b""] * B, prefixes, cap=0,
                                          with_dict=True)
    _, _, hist_d, hlen_d = to_device_batch(src0, lens0, hist, hlen,
                                           device="cuda")
    comp_d, plens_d, _, _ = to_device_batch(
        arenas.reshape(waves * B, eng.PIECE_CAP), plens.reshape(-1),
        device="cuda")
    k_piece = cuda_ms(lambda: eng._decode_pieces(comp_d, plens_d, hist_d,
                                                 hlen_d, waves=waves))
    # the wave-major arenas' one H2D against the tight pack of lz4_tpu
    # engine.py:716-722 (each block's pieces back to back, one H2D, then
    # each wave's pieces cut out per row on the device)
    poffs = np.zeros((waves, B), np.int64)
    for i, (_, pl, _) in enumerate(splits):
        poffs[1: len(pl), i] = np.cumsum(pl[:-1])
    packed = np.zeros((B, int(plens.sum(0).max()) + eng.PIECE_CAP),
                      np.uint8)
    for i, (arena, pl, _) in enumerate(splits):
        packed[i, : int(pl.sum())] = np.concatenate(
            [arena[k, : pl[k]] for k in range(len(pl))])
    ar = torch.arange(eng.PIECE_CAP, device="cuda")

    def tight_cut():
        p = torch.from_numpy(packed).cuda()
        o = torch.from_numpy(poffs).cuda()
        return [p.gather(1, o[k][:, None] + ar) for k in range(waves)]
    # B2 reads a piece up to its length: the cuts must agree there
    live = torch.arange(eng.PIECE_CAP) < torch.from_numpy(plens)[..., None]
    if not torch.equal(torch.stack(tight_cut()).cpu()[live],
                       torch.from_numpy(arenas)[live]):
        raise AssertionError("the tight pack's cut differs from the arenas")
    h2d_pad = cuda_ms(lambda: torch.from_numpy(arenas).cuda())
    h2d_tight = cuda_ms(lambda: torch.from_numpy(packed).cuda())
    tight_ms = cuda_ms(tight_cut)
    # B2 on whole 4 MB rows: the kernel, and with its host steps
    cap_in = -(-max(len(c) for c in blocks) // 4) * 4
    rows = to_device_batch(*pack_blocks(blocks, prefixes, cap=cap_in,
                                        with_dict=True), device="cuda")
    k_rows = cuda_ms(lambda: decode_cuda.decode_blocks(*rows, cap_out=MB4),
                     runs=3)

    def whole_rows():
        out, olen, err = decode_cuda.decode_blocks(*to_device_batch(
            *pack_blocks(blocks, prefixes, cap=cap_in, with_dict=True),
            device="cuda"), cap_out=MB4)
        out, olen = out.cpu().numpy(), olen.cpu().tolist()
        if err.any():
            raise AssertionError("B2 whole rows flagged an error")
        return [out[i, : olen[i]].tobytes() for i in range(B)]
    t_rows, got = host_ms(whole_rows)
    if got != want:
        raise AssertionError("B2 on whole 4 MB rows differs")
    e2e_rows = cuda_ms(whole_rows, runs=3)
    host = {}
    for n in (1, default_nb_workers()):
        hb = HostBackend(nb_workers=n)
        if hb.decompress_batch(blocks, caps, dict_prefixes=prefixes) != want:
            raise AssertionError("host decode differs")
        host[n], _ = min(host_ms(lambda: hb.decompress_batch(
            blocks, caps, dict_prefixes=prefixes)) for _ in range(3))
    log(f"4 x 4 MB linked blocks ({sum(map(len, blocks))} bytes): piece "
        f"route {e2e_piece:.3f} ms ({waves} waves = B2 launches, the waves "
        f"alone {k_piece:.3f} ms; first call {t_piece:.1f} ms), B2 on "
        f"whole 4 MB rows {e2e_rows:.3f} ms (the kernel alone "
        f"{k_rows:.3f} ms), host tier " + ", ".join(
            f"{v:.3f} ms with {k} worker{'s' if k > 1 else ''}"
            for k, v in host.items()))
    log(f"piece arenas: one H2D of the wave-major [{waves}, {B}, "
        f"{eng.PIECE_CAP}] arenas ({arenas.nbytes} bytes) {h2d_pad:.3f} ms; "
        f"the tight pack ({packed.nbytes} bytes) {h2d_tight:.3f} ms for its "
        f"H2D, {tight_ms:.3f} ms with its {waves} per-wave cuts")
    return {"waves": waves, "launches": launches["B2"], "ms": e2e_piece,
            "waves_ms": k_piece, "rows_ms": e2e_rows, "rows_kernel_ms": k_rows,
            "host_ms": host}


def phase_sortscan_decode(be):
    """decode_sortscan.decode_blocks on the 768 x 64 KB main batch and on
    mutated streams, held to B2 (errs on every row; out and out_lens
    where err is 0, B2's contract), then TorchBackend with serial_decode
    and serial_encode off."""
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    B = len(blocks)
    comp = native.blockcodec.compress_batch(blocks)
    bad = mutations(comp[:64], 256, seed=77)
    worst = 0
    for name, streams in (("main batch", comp), ("mutated", bad)):
        cap_in = -(-max(len(c) for c in streams) // 4) * 4
        arrays = to_device_batch(*pack_blocks(streams, cap=cap_in),
                                 device="cuda")
        reset_launches()
        ss = decode_sortscan.decode_blocks(*arrays[:2], cap_out=BLOCK,
                                           has_dict=False)
        if sum(read_launches().values()):
            raise AssertionError("the sort/scan decoder launched a kernel")
        b2 = decode_cuda.decode_blocks(*arrays[:2], cap_out=BLOCK)
        so, sl, se = (t.cpu() for t in ss)
        bo, bl, be_ = (t.cpu() for t in b2)
        if not torch.equal(se, be_):
            raise AssertionError(f"sort/scan errs differ from B2 ({name})")
        ok = (se == 0).nonzero().flatten().tolist()
        if not torch.equal(sl[ok], bl[ok]):
            raise AssertionError(f"sort/scan out_lens differ ({name})")
        for i in ok:
            n = int(sl[i])
            if not torch.equal(so[i, :n], bo[i, :n]):
                raise AssertionError(f"sort/scan row {i} differs ({name})")
        if name == "main batch":
            if se.any() or [so[i, : len(b)].numpy().tobytes()
                            for i, b in enumerate(blocks)] != blocks:
                raise AssertionError("sort/scan main batch round trip")
            ms = cuda_ms(lambda: decode_sortscan.decode_blocks(
                *arrays[:2], cap_out=BLOCK, has_dict=False), runs=3)
            R = decode_sortscan.chunk_rows(cap_in, BLOCK,
                                           arrays[0].device)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            decode_sortscan.decode_blocks(arrays[0][:R], arrays[1][:R],
                                          cap_out=BLOCK, has_dict=False)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            csum = sum(len(c) for c in comp)
            main_cap = cap_in
        log(f"sort/scan decoder == B2 on {len(streams)} rows ({name}, "
            f"{int(se.sum())} flagged)")
    budget = decode_sortscan.BUDGET["cuda"]
    per_pos = peak / (min(R, B) * (main_cap + BLOCK + DICT_CAP) * 8)
    if peak > budget:
        raise AssertionError("a sort/scan decode chunk exceeds its budget")
    bound = (csum + B * 4 + len(data) + B * 8) / HBM_BYTES_PER_S * 1e3
    # the route through TorchBackend: sort/scan encode (2 candidates) and
    # decode, the wave tier off
    be.serial_decode = be.serial_encode = False
    be.wave_decode = False
    n0 = be.sortscan_decoded
    try:
        reset_launches()
        t_c, rcomp = host_ms(lambda: be.compress_batch(blocks, level=1))
        t_d, back = host_ms(lambda: be.decompress_batch(rcomp, [BLOCK] * B))
        launches = read_launches()
    finally:
        be.serial_decode = be.serial_encode = True
        be.wave_decode = True
    if back != blocks or sum(launches.values()) or \
            be.sortscan_decoded != n0 + 1:
        raise AssertionError(f"serial switches off: launches {launches}, "
                             f"round trip {back == blocks}")
    if native.blockcodec.decompress_batch(rcomp, [BLOCK] * B) != blocks:
        raise AssertionError("sort/scan level 1 streams fail the C decoder")
    log(f"sort/scan decoder on {B} x 64 KB: {ms:.3f} ms on the card "
        f"({len(data) / 1e6 / ms * 1e3:.1f} MB/s), bound {bound:.4f} ms "
        f"(bytes); one chunk of {min(R, B)} rows peaks at "
        f"{peak / 2**30:.3f} GiB of its {budget / 2**30:.0f} GiB budget "
        f"({per_pos:.2f} int64 lanes a position, sized by "
        f"{decode_sortscan._LANES}); TorchBackend with serial_decode and "
        f"serial_encode off: compress {t_c:.1f} ms, decompress {t_d:.1f} ms "
        f"(host clock), launches {launches}, ratio "
        f"{len(data) / sum(map(len, rcomp)):.4f}")
    return {"ms": ms, "bound_ms": bound, "peak": peak}


def phase_sharded():
    """The multi-GPU engine on a world-size-1 NCCL group (one H100: the
    collectives run, nothing crosses cards), held to the single-device
    routes."""
    import torch.distributed as dist
    from lz4_tpu_torch.parallel import dryrun
    with tempfile.TemporaryDirectory() as tdir:
        store = dist.FileStore(os.path.join(tdir, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            reset_launches()
            line = dryrun.dryrun_multichip(1, per_rank=8,
                                           out=os.path.join(tdir, "r.npz"))
            launches = read_launches()
            r = dict(np.load(os.path.join(tdir, "r.npz")))
            src, B = r["src"], r["src"].shape[0]
            lens = np.full(B, BLOCK, np.int32)
            # single-device routes on the same inputs
            dbufs = np.zeros((B, DICT_CAP), np.uint8)
            dbufs[1:] = src[:-1, -DICT_CAP:]
            dlens = np.asarray([0] + [DICT_CAP] * (B - 1), np.int32)
            out, cs, _ = encode_sortscan.encode_blocks(*to_device_batch(
                src, lens, dbufs, dlens, device="cuda"), cap_n=BLOCK,
                has_dict=True)
            if not (np.array_equal(out.cpu().numpy(), r["comp"])
                    and np.array_equal(cs.cpu().numpy(), r["csizes"])):
                raise AssertionError("linked_encode_step != one device")
            eo, es, _ = encode_sortscan.encode_blocks(*to_device_batch(
                src, lens, device="cuda"), cap_n=BLOCK, has_dict=False)
            if not np.array_equal(eo.cpu().numpy(), r["eout"]):
                raise AssertionError("ShardedCodec.encode != one device")
            cap_in = r["comp"].shape[1]
            dec = decode_sortscan.decode_blocks(*to_device_batch(
                r["comp"], r["csizes"], dbufs, dlens, device="cuda"),
                cap_out=BLOCK, has_dict=True)
            if not all(np.array_equal(a.cpu().numpy(), r[k]) for a, k in
                       zip(dec, ("dout", "dlen", "derr"))):
                raise AssertionError("ShardedCodec.decode != one device")
            wblocks = [gen_buffer(4096, match_prob=0.7, seed=200 + i)
                       for i in range(B)]
            wdec = encode_wave.find_matches(*to_device_batch(
                *encode_wave.pack_input(wblocks, 1024), device="cuda"),
                max_dist=2048, hash_bits=9)
            if not np.array_equal(wdec.cpu().numpy(), r["wdec"]):
                raise AssertionError("wave_encode_sharded != one device")
            # TorchBackend(codec=...) on main-path blocks, every device route
            data = real_corpus(CORPUS)[: 64 * BLOCK]
            blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
            sb = TorchBackend(codec=eng.ShardedCodec())
            single = TorchBackend()
            sb.wave_decode = single.wave_decode = False
            for level in (1, 2):
                c1 = sb.compress_batch(blocks, level=level)
                if c1 != single.compress_batch(blocks, level=level):
                    raise AssertionError(f"sharded level {level} differs")
                for serial in (True, False):
                    sb.serial_decode = single.serial_decode = serial
                    if sb.decompress_batch(c1, [BLOCK] * 64) != blocks:
                        raise AssertionError("sharded decode round trip")
            after = read_launches()
        finally:
            dist.destroy_process_group()
    for k in ("B1", "B2", "B4"):
        if after[k] < 1:
            raise AssertionError(f"the sharded phase skipped {k}: {after}")
    log(f"sharded engine, world size 1 on NCCL (one H100; no collective "
        f"crosses cards): {line}; == the single-device routes "
        f"(linked_encode_step, ShardedCodec.encode/decode, "
        f"wave_encode_sharded, TorchBackend(codec) levels 1-2 with B2 and "
        f"sort/scan decode); launches {after} (dryrun alone {launches}), "
        f"cap_in {cap_in}")


def phase_cli():
    """The CLI in process on a 16 MB file: -9 -B4 (B5), -d, -t, and a
    default -1 round trip; the files are compared byte for byte. Returns
    the -9 -B4 file's bytes."""
    data = real_corpus(CORPUS)[: 16 << 20]
    with tempfile.TemporaryDirectory() as tdir:
        src = os.path.join(tdir, "corpus16.bin")
        with open(src, "wb") as f:
            f.write(data)
        for flags in (["-9", "-B4"], ["-1"]):
            dst = os.path.join(tdir, "c.lz4")
            out = os.path.join(tdir, "c.out")
            reset_launches()
            t_c, rc = host_ms(lambda: cli.main(["lz4", "-f", *flags, src,
                                                dst]))
            on_compress = read_launches()
            t_d, rc_d = host_ms(lambda: cli.main(["lz4", "-d", "-f", dst,
                                                  out]))
            t_t, rc_t = host_ms(lambda: cli.main(["lz4", "-t", dst]))
            if (rc, rc_d, rc_t) != (0, 0, 0):
                raise AssertionError(f"CLI {flags} exit codes {rc, rc_d, rc_t}")
            if not filecmp.cmp(src, out, shallow=False):
                raise AssertionError(f"CLI {flags} round trip differs (cmp)")
            if flags[0] == "-9":
                with open(dst, "rb") as f:
                    hc_file = f.read()
            want = "B5" if flags[0] == "-9" else "B1"
            if on_compress[want] < 1:
                raise AssertionError(f"CLI {flags} compress skipped {want}: "
                                     f"{on_compress}")
            size = os.path.getsize(dst)
            log(f"CLI {' '.join(flags)}: 16 MB -> {size} bytes (ratio "
                f"{len(data) / size:.4f}); compress {t_c:.1f} ms, -d "
                f"{t_d:.1f} ms, -t {t_t:.1f} ms (host clock, whole calls); "
                f"cmp ok; launches {read_launches()}")
    return hc_file


def phase_bench():
    """The port's bench in process at 8 MB, 1 s per timed loop."""
    reset_launches()
    buf = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stdout(buf):
        r = bench.main(mb=8, seconds=1.0)
    launches = read_launches()
    buf.flush()
    line = buf.buffer.getvalue().decode().strip().splitlines()[-1]
    if json.loads(line) != r or r["detail"]["device"] != "cuda":
        raise AssertionError(f"bench printed an unexpected line: {line}")
    if launches["B6"] < 1:
        raise AssertionError(f"bench skipped B6: {launches}")
    log(f"bench (8 MB, 1 s): {line}")
    log(f"bench launches {launches}")
    return launches


# ------------------------------------------------ frame pump and surfaces

def _outcome(fn):
    """("ok", None) when fn() returns, else the class name and code of
    what it raised."""
    try:
        fn()
        return "ok", None
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, getattr(e, "code", None)


def phase_frame_pump():
    """The C frame walker behind `HostBackend` frame decodes: three 16 MB
    frames decoded with the pump on and off (bytes equal, pump calls
    counted), fed in 4099-byte and 1 MiB chunks, 64 mutated frames (the
    same class and code both ways), and the CLI's `--backend host -d`;
    host-clock ms, best of 4 after a warm-up, pump and walk in turns."""
    corpus = real_corpus(CORPUS)
    data = corpus[: 16 << 20]
    host = HostBackend()
    frames = host_frame.make_frames(data, corpus[-65536:], host)
    calls = []
    pump_fn = host._native.frame_pump
    host._native.frame_pump = lambda *a: (calls.append(1), pump_fn(*a))[1]
    try:
        for name, (frame, d) in frames.items():
            del calls[:]
            back = decompress_frame(frame, backend=host, dict_content=d)
            n_pump = len(calls)
            with host_frame.pump(False):
                walked = decompress_frame(frame, backend=host,
                                          dict_content=d)
            if not (back == walked == data) or not n_pump or \
                    len(calls) != n_pump:
                raise AssertionError(f"{name}: pump {n_pump} calls, walk "
                                     f"{len(calls) - n_pump}, bytes equal "
                                     f"{back == walked == data}")
            short = {}
            for chunk in (4099, 1 << 20):
                # a feed may stop before the end of its input (a block
                # word completed from the buffer); the rest is fed again,
                # as the I/O engine does
                dec = FrameDecompressor(backend=host, dict_content=d)
                out = bytearray()
                short[chunk] = 0
                for i in range(0, len(frame), chunk):
                    piece = frame[i: i + chunk]
                    while piece:
                        o, used = dec.feed(piece)
                        out += o
                        piece = piece[used:]
                        if piece and not used:
                            raise AssertionError(f"{name}: a feed of "
                                                 f"{chunk} stalled")
                        short[chunk] += bool(piece)
                if not dec.frame_done or out != data:
                    raise AssertionError(f"{name}: {chunk}-byte feeds differ")
            log(f"frame pump: {name} ({len(frame)} bytes) == the Python walk "
                f"== the source; {n_pump} pump calls; 4099-byte and 1 MiB "
                f"feeds equal (feeds that stopped short: {short})")
    finally:
        del host._native.frame_pump
    rng = np.random.default_rng(64)
    names = list(frames)
    kinds = {}
    for k in range(64):
        name = names[k % len(names)]
        frame, d = frames[name]
        m = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(7, len(m)))] ^= int(rng.integers(1, 256))
        m = bytes(m)
        pumped = _outcome(lambda: decompress_frame(m, backend=host,
                                                   dict_content=d))
        with host_frame.pump(False):
            walked = _outcome(lambda: decompress_frame(m, backend=host,
                                                       dict_content=d))
        if pumped != walked or pumped[0] == "ok":
            raise AssertionError(f"mutated {name} #{k}: pump {pumped}, walk "
                                 f"{walked}")
        kinds[pumped] = kinds.get(pumped, 0) + 1
    log("frame pump: 64 mutated frames raise the same class and code both "
        "ways: "
        + str(sorted((f"{c}:{code}", n) for (c, code), n in kinds.items())))
    t_frames = host_frame.time_frames(frames, data, host, 4)
    t_cli = host_frame.time_cli(data, 4)
    log("frame pump: decompress_frame on HostBackend, 16 MB, ms (host "
        "clock, best of 4 after a warm-up, in turns; pump / Python walk): "
        + ", ".join(f"{k} {v['pump']:.3f} / {v['walk']:.3f}"
                    for k, v in t_frames.items())
        + f"; CLI --backend host -d {t_cli['-d']['pump']:.3f} / "
        f"{t_cli['-d']['walk']:.3f} (-1 compress {t_cli['compress_ms']:.3f})"
        " [PR 9: 38.0 ms for the 4 MB linked frame's decode on the host; "
        "PR 6: CLI -1 -d 49.3 / 49.7 ms on the host]")
    return {"frames": t_frames, "cli": t_cli}


def phase_one_shot():
    """lz4_tpu_torch.compress / decompress on the default backend (the
    GPU) over the 48 MB corpus in 64 KB blocks: level 1 independent (B1,
    then B3) and linked (B1 with history, then B2 a block), and level 9
    (B5, then B3); each frame also decodes through HostBackend."""
    data = real_corpus(CORPUS)
    host = HostBackend()
    cases = (("level 1, independent", 1, True, "B1", "B3"),
             ("level 1, linked", 1, False, "B1", "B2"),
             ("level 9, independent", 9, True, "B5", "B3"))
    totals = {k: 0 for k in KERNELS}
    for what, level, independent, enc_k, dec_k in cases:
        prefs = Preferences(frame_info=FrameInfo(
            block_size_id=4, block_independent=independent,
            content_checksum=True))
        reset_launches()
        t_c, frame = host_ms(lambda: lz4_tpu_torch.compress(
            data, level, prefs=prefs))
        on_c = read_launches()
        t_d, back = host_ms(lambda: lz4_tpu_torch.decompress(frame))
        launches = read_launches()
        on_d = {k: launches[k] - on_c[k] for k in launches}
        if back != data or decompress_frame(frame, backend=host) != data:
            raise AssertionError(f"one-shot {what}: round trip differs")
        if on_c[enc_k] < 1 or on_d[dec_k] < 1:
            raise AssertionError(f"one-shot {what} skipped {enc_k} or "
                                 f"{dec_k}: {on_c} then {on_d}")
        for k in totals:
            totals[k] += launches[k]
        log(f"one-shot {what}: {len(data) >> 20} MB -> {len(frame)} bytes "
            f"(ratio {len(data) / len(frame):.4f}); compress {t_c:.1f} ms, "
            f"launches {on_c}; decompress {t_d:.1f} ms, launches {on_d} "
            f"(host clock, single shots, default backend "
            f"{type(default_backend()).__name__}); HostBackend decode equal")
    return totals


def phase_host_surfaces():
    """xxh64 over the corpus (held to XXH64State and the public vector)
    and compress_destsize on 768 x 64 KB blocks at a 16 KB cap."""
    data = real_corpus(CORPUS)
    if lz4_tpu_torch.xxh64(b"") != 0xEF46DB3751D8E999 or \
            XXH64State().digest() != 0xEF46DB3751D8E999:
        raise AssertionError("xxh64 misses the public vector of b''")
    mb = data[: 1 << 20]
    if lz4_tpu_torch.xxh64(mb, 7) != XXH64State(7).update(mb).digest():
        raise AssertionError("xxh64 != XXH64State on 1 MB")
    t_x = min(host_ms(lambda: lz4_tpu_torch.xxh64(data))[0]
              for _ in range(4))
    bc = native.blockcodec
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    t_d, outs = host_ms(lambda: [bc.compress_destsize(b, 16384)
                                 for b in blocks])
    consumed = strict = 0
    for b, (c, n) in zip(blocks, outs):
        if len(c) > 16384 or bc.decompress(c, len(b)) != b[:n]:
            raise AssertionError("compress_destsize output over the cap or "
                                 "not decoding to its prefix")
        consumed += n
        # the strict decoder at a capacity of exactly `consumed` also holds
        # the end rules (the last match starts >= 12 bytes before the end)
        strict += _outcome(lambda: bc.decompress(c, n))[0] != "ok"
    log(f"host surfaces: xxh64 of 48 MB {t_x:.3f} ms (best of 3 after a "
        f"warm-up, {len(data) / 1e6 / t_x * 1e3:.1f} MB/s; == XXH64State on "
        f"1 MB and the public vector); compress_destsize on {len(blocks)} x "
        f"64 KB at cap 16384 {t_d:.1f} ms, {consumed} source bytes in "
        f"{sum(len(c) for c, _ in outs)} (each <= cap, host decode == "
        f"block[:consumed]; host clock); {strict} streams break the end "
        f"rules at a capacity of exactly consumed (the reference's too)")


def phase_examples():
    """Each teaching program's main() on the card, its launches counted
    (counts set to 0 just before each); `sharded_batch` makes its own
    process group, which must be NCCL."""
    import torch.distributed as dist
    totals = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tdir:
        path = os.path.join(tdir, "sample.bin")
        with open(path, "wb") as f:
            f.write(real_corpus(CORPUS)[: 8 << 20])
        for name in EXAMPLES:
            mod = importlib.import_module(f"lz4_tpu_torch.examples.{name}")
            buf = io.StringIO()
            groups = []
            init = dist.init_process_group
            dist.init_process_group = lambda backend, **kw: (
                groups.append(backend), init(backend, **kw))[1]
            reset_launches()
            try:
                with contextlib.redirect_stdout(buf):
                    t, _ = host_ms(lambda: mod.main(path) if name ==
                                   "file_compress" else mod.main())
            finally:
                dist.init_process_group = init
            launches = read_launches()
            for k in totals:
                totals[k] += launches[k]
            if not buf.getvalue().strip():
                raise AssertionError(f"example {name} printed nothing")
            if name == "turbo_wave_mode" and not (launches["B4"] and
                                                  launches["B3"]):
                raise AssertionError(f"turbo_wave_mode skipped B4 or B3: "
                                     f"{launches}")
            if name == "sharded_batch" and groups != ["nccl"]:
                raise AssertionError(f"sharded_batch made groups {groups}")
            lines = buf.getvalue().strip().replace(tdir, "<tmp>")
            log(f"example {name} ({t:.1f} ms, launches {launches}"
                + (", its own NCCL group of 1" if groups else "") + "): "
                + " | ".join(lines.splitlines()))
    return totals


TORTURE_RUNS = (("kernels, wave", {"kernels": True, "wave": True}, 45.0),
                ("sort/scan", {}, 15.0))
#: the decode legs that must see mutated streams in the torture phase
TORTURE_LEGS = ("B2", "wave", "sortscan")


def phase_torture():
    """The differential fuzzer (`probes/torture.py`) on the card for a
    fixed time: `--kernels --wave` (B1, B2, the wave splitter with B3, the
    linked ring, the batch frames with B4), then the default mode's
    sort/scan legs. Raises on any disagreement (`torture.run` prints the
    failing cycle's seed) and where a device decode leg saw no mutated
    stream. Returns each kernel's launches over the phase (counts set to
    0 just before it), probe kernels by source."""
    oracle = torture.find_oracle()
    reset_launches()
    probe0 = {mod.SOURCE: mod.launches for mod in PROBES}
    totals = Counter()
    for name, kw, secs in TORTURE_RUNS:
        opts = torture.Options(device="cuda", oracle=oracle, **kw)
        before = read_launches()
        t0 = time.perf_counter()
        seed, c = torture.run(opts, secs)
        t = time.perf_counter() - t0
        totals.update(c)
        on = {k: v - before[k] for k, v in read_launches().items()}
        log(f"torture ({name}): master seed {seed}, {c['cycles']} cycles in "
            f"{t:.1f} s ({c['cycles'] / t:.2f} a second), oracle: "
            f"{'liblz4' if oracle else 'none'}; launches {on}")
        for line in torture.summary(c):
            log(f"torture ({name}): {line}")
    missing = [leg for leg in TORTURE_LEGS if not totals[f"mutated.{leg}"]]
    if missing or totals["disagreements"]:
        raise AssertionError(f"torture: no mutated stream reached {missing}"
                             f" ({totals['disagreements']} disagreements)")
    launches = read_launches()
    launches.update({src: mod.launches - probe0[src]
                     for mod in PROBES for src in [mod.SOURCE]})
    return launches


#: the stages of the main path's shape (768 x 64 KB): level 2's encode
#: split and the sort/scan decoder's
FULLBENCH_MAIN = ("encode_mixed", "etables_mixed", "ejump_mixed",
                  "eparse_mixed", "eemit_mixed", "decode_mixed",
                  "dparse_mixed")


def phase_fullbench():
    """The per-stage micro-benchmark (`probes/fullbench.py`): every stage
    at the tool's defaults (B 32), then level 2's encode split and the
    sort/scan decoder's at the main path's 768 x 64 KB (`--level 2`),
    0.5 s a stage; then the same splits on the main path's own batch
    (the 48 MB real-file corpus: level 2's stream-less encode, and the
    decode of the host C level-1 streams that the sort/scan decode phase
    times). Launches no kernel."""
    reset_launches()
    t0 = time.perf_counter()
    rows = fullbench.run("cuda", B=32, NB=BLOCK, seconds=0.5,
                         emit=lambda line: log(f"fullbench {line}"))
    if [r["stage"] for r in rows] != fullbench.stage_names():
        raise AssertionError("fullbench skipped stages")
    big = fullbench.run("cuda", B=CORPUS // BLOCK, NB=BLOCK, seconds=0.5,
                        stages=FULLBENCH_MAIN, level=2,
                        emit=lambda line: log(f"fullbench 768 {line}"))
    if [r["stage"] for r in big] != list(FULLBENCH_MAIN):
        raise AssertionError("fullbench skipped a main-shape stage")
    # the main path's batch: level 2 (8 candidates, lazy), and for the
    # decoder the host C level-1 streams of the sort/scan decode phase
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    src, lens, _, _ = to_device_batch(*pack_blocks(blocks, cap=BLOCK),
                                      device="cuda")
    split = fullbench.EncodeSplit(src, lens, *fullbench.LEVELS[2])
    comp = native.blockcodec.compress_batch(blocks)
    cap_in = -(-max(len(c) for c in comp) // 4) * 4
    cdev, clen, _, _ = to_device_batch(*pack_blocks(comp, cap=cap_in),
                                       device="cuda")
    real = {}
    for name, fn in (
            ("encode", lambda: encode_sortscan.encode_blocks(
                src, lens, cap_n=BLOCK, has_dict=False,
                n_cand=8, lazy=True)),
            ("etables", split.tables), ("ejump", split.jump),
            ("eemit", split.emit),
            ("decode", lambda: decode_sortscan.decode_blocks(
                cdev, clen, cap_out=BLOCK, has_dict=False)),
            ("dparse", lambda: fullbench.dparse(cdev, clen, BLOCK))):
        ms, host, _ = timed_runs(fn, 0.5)
        real[name] = {"ms": ms, "host_ms": host}
    del split
    enc, dec = real["encode"]["ms"], real["decode"]["ms"]
    log("fullbench real corpus (768 x 64 KB): " + ", ".join(
        f"{k} {v['ms']:.3f} ms ({v['host_ms']:.3f} host)"
        for k, v in real.items())
        + f"; of level 2's encode: tables "
        f"{real['etables']['ms'] / enc:.1%}, parse "
        f"{real['ejump']['ms'] / enc:.1%}, emit "
        f"{real['eemit']['ms'] / enc:.1%}; of the decode: parse "
        f"{real['dparse']['ms'] / dec:.1%}")
    if sum(read_launches().values()):
        raise AssertionError("fullbench launched a kernel")
    log(f"fullbench phase: {time.perf_counter() - t0:.1f} s")


def phase_checkframe(frames16, hc_file, batch):
    """The port's frame validator (`lz4_tpu_torch.checkframe`, host only)
    on frames the smoke wrote: the 16 MB linked and independent frames,
    the CLI's -9 -B4 file, the 128 linked batch frames (one file), a
    legacy and a skippable frame; three corrupted copies must fail."""
    legacy = compress_legacy_frame(frames16["linked"][: 1 << 20],
                                   backend=HostBackend())
    files = {"linked16": frames16["linked"],
             "independent16": frames16["independent"], "cli9B4": hc_file,
             "batch128": b"".join(batch), "legacy": legacy,
             "skippable": write_skippable_frame(b"smoke" * 20, 5)}
    base = frames16["independent"]
    bad = {"bad-magic": b"\x00" + base[1:],
           "bad-header-checksum": base[:6] + bytes([base[6] ^ 0xFF])
           + base[7:],
           "truncated": base[: len(base) // 2]}
    want = {"linked16": 4, "independent16": 256, "batch128": None}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tdir:
        paths = {}
        for name, blob in {**files, **bad}.items():
            paths[name] = os.path.join(tdir, f"{name}.lz4")
            with open(paths[name], "wb") as f:
                f.write(blob)
        for name in files:
            frames = checkframe.check_file(paths[name])
            if name == "batch128" and len(frames) != len(batch):
                raise AssertionError(f"checkframe: {len(frames)} frames in "
                                     f"the batch file")
            if want.get(name) and frames[0]["blocks"] != want[name]:
                raise AssertionError(f"checkframe {name}: {frames}")
            log(f"checkframe {name}: OK, {len(frames)} frame(s), "
                f"{sum(f.get('blocks', 0) for f in frames)} blocks")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_ok = checkframe.main([paths[n] for n in files])
            rc_bad = [checkframe.main([paths[n]]) for n in bad]
    if rc_ok != 0 or rc_bad != [1] * len(bad):
        raise AssertionError(f"checkframe exit codes {rc_ok}, {rc_bad}: "
                             f"{out.getvalue()}")
    log(f"checkframe: {len(files)} valid files exit 0, {len(bad)} corrupted "
        f"copies exit 1 ({', '.join(bad)}) in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host)")


PROBES = (gather_probe, walk_probe, lane_probe)


def _probe_times(e: dict, prefix: str = "") -> str:
    """A probe body's (or, with prefix "library_", its library call's)
    ms after a sync, back to back, behind an L2 flush, and host and
    device us a call, as far as it has them."""
    text = (f"{e[prefix + 'ms']:.4f} ms ({e[prefix + 'ms_back_to_back']:.4f}"
            f" back to back")
    if prefix + "ms_l2_flushed" in e:
        text += f", {e[prefix + 'ms_l2_flushed']:.4f} L2 flushed"
    if prefix + "host_us" in e:
        text += (f", host {e[prefix + 'host_us']:.2f} us and device "
                 f"{e[prefix + 'device_us']:.2f} us a call")
    return text + ")"


def phase_probes():
    """The TPU probes of tools/ (P1-P4) on their Hopper kernels: every
    body timed at the tool's sizes, and the output of its last timed
    launch held against its plain version on the same inputs (exact),
    through `probes/_common.measure`, with each probe's launch count set
    to 0 just before and read just after (each body's `launches` are
    those its timing made). The chain bodies' bounds are priced by the
    latency build (`walk_probe.latencies`) at the SM clock nvidia-smi reads
    while the card is busy, both taken before the bodies run, and each is
    held to the cycles its longest chain took; P1 chase's throughput bound
    over the card's SMs (`gather_probe.chase_card_bound`) to the cycles its
    slowest block took, with its route and cluster size
    (`gather_probe.chase_plan`) beside it, on each of its two bodies.
    Returns the kernels line's entries and the {"chain_bounds": ...}
    line."""
    floor = probe_floor()
    log("probe chain prices (latency build, SM cycles an instruction on "
        f"chains of {walk_probe.LAT_STEPS}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in floor.cycles.items())
        + f"; the launch ran at {floor.kernel_mhz:.1f} MHz (clock64 over "
        f"globaltimer); nvidia-smi clocks.sm {floor.sm_mhz:.0f} MHz (max "
        f"{floor.sm_max_mhz:.0f}, busy at the read: {floor.busy_at_read})")
    entries = []
    for mod in PROBES:
        mod.launches = 0
        res = measure(mod.bodies(), lambda mod=mod: mod.launches,
                      floor=floor)
        if sum(r["launches"] for r in res.values()) != mod.launches:
            raise AssertionError(f"{mod.__name__}: launches per body do "
                                 f"not add up to {mod.launches}")
        for name, r in res.items():
            e = {"name": name, "route": "cuda", "source": mod.SOURCE,
                 "path": "probes", **r}
            entries.append(e)
            log(f"probe {name}: {_probe_times(e)} ({e['launches']} "
                f"launches)"
                + (f", {e['cycles_per_step']:.2f} SM cycles a step"
                   if "cycles_per_step" in e else "")
                + (f"; library {_probe_times(e, 'library_')}"
                   if e["library_ms"] is not None else "")
                + (f"; chain bound {e['chain_bound_ms']:.6f} ms, "
                   f"{e['chain_cycles_per_step']:.2f} SM cycles a step of "
                   f"the longest chain against "
                   f"{e['longest_chain_cycles'] / e['longest_chain']:.2f} "
                   f"measured (share {e['chain_share']:.3f} of ms, "
                   f"{e['chain_cycles_share']:.3f} of its cycles)"
                   if "chain_bound_ms" in e else "")
                + (f"; {e['chase_route']} body, {e['cluster']} CTAs a "
                   f"block, {e['max_active_clusters']} clusters resident at "
                   f"most" if "chase_route" in e else "")
                + (f"; throughput bound {e['throughput_bound_ms']:.6f} ms, "
                   f"{e['throughput_bound_cycles']:.1f} SM cycles over "
                   f"{e['sms']} SMs ("
                   f"{e['throughput_bound_cycles_one_sm']:.1f} on one SM) "
                   f"against {e['longest_chain_cycles']:.0f} of the slowest "
                   f"block (share {e['throughput_share']:.3f} of ms, "
                   f"{e['throughput_cycles_share']:.3f} of its cycles)"
                   if "throughput_bound_ms" in e else "")
                + f"; plain {e['plain_ms']:.1f} ms, "
                + ("== plain" if e["same_as_plain"] else "DIFFERS")
                + f" at {e['count']}")
    bad = [e["name"] for e in entries
           if not e["same_as_plain"] or not e["launches"]]
    if bad:
        raise AssertionError(f"probe kernels differ from plain or were "
                             f"not launched: {bad}")
    # a chain bound is a least time: above the cycles its chain took, a
    # SASS count in CHAINS or a price is wrong (the margin is the spread
    # of the latency build's prices between calls, 2.6% at most)
    # the throughput bound (k_chase, over the card's SMs) is a least time
    # too
    over = {e["name"]: e[k] for e in entries
            for k in ("chain_cycles_share", "throughput_cycles_share")
            if e.get(k, 0.0) > 1.03}
    if over:
        raise AssertionError(f"chain or throughput bounds above the cycles "
                             f"their kernels took: {over}")
    keys = ("ms", "cycles_per_step", "longest_chain", "chain",
            "chain_cycles_per_step", "chain_bound_cycles", "chain_bound_ms",
            "chain_share", "longest_chain_cycles", "chain_cycles_share",
            "chase_route", "cluster", "max_active_clusters", "sms",
            "throughput_bound_cycles", "throughput_bound_cycles_one_sm",
            "throughput_bound_ms", "throughput_share",
            "throughput_cycles_share")
    chains = {**asdict(floor), "bodies": {
        e["name"]: {k: e[k] for k in keys if k in e}
        for e in entries if "chain_share" in e}}
    return entries, {"chain_bounds": chains}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind}")

    secs = _build.build()
    secs.update({f"{k} latency": v for k, v in _build.build(
        [walk_probe.LIB], walk_probe.LATENCY).items()})
    t0 = time.perf_counter()
    native.load()
    secs["host C"] = time.perf_counter() - t0
    log("build seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    enc_err, dec_err, wave_err, match_err = phase_kernels_vs_plain()
    hc_err, xxh_err = phase_hc_xxh_vs_plain()
    xxh_4mb_ms = phase_xxh_host()
    be = TorchBackend()
    m = phase_main_path(be)
    md = phase_max_dist(be)
    frames16 = phase_frames(be)
    big = phase_big_blocks(be)
    batch = phase_batch_frames(be)
    hc = phase_hc_path(be)
    phase_level2(be)
    phase_sortscan_decode(be)
    phase_host_pool()
    phase_sharded()
    hc_file = phase_cli()
    bench_launches = phase_bench()
    phase_frame_pump()
    one_shot = phase_one_shot()
    phase_host_surfaces()
    example_launches = phase_examples()
    torture_launches = phase_torture()
    phase_fullbench()
    phase_checkframe(frames16, hc_file, batch)
    probes, chains = phase_probes()

    common = {"route": "cuda", "bound_by": "bytes", "library_ms": None,
              "blocks": m["blocks"], "plain_blocks": PLAIN_ROWS}
    kernels = [
        {"name": "B1 encode_serial",
         "source": "lz4_tpu_torch/csrc/encode_serial.cu",
         "replaces": "lz4_tpu/block/encode_pallas.py:54",
         "launches": m["launches"]["B1"], "path": "main",
         "max_abs_err": max(enc_err, m["enc_err"]),
         "ms": m["enc_ms"], "plain_ms": m["plain_enc_ms"],
         "bound_ms": m["enc_bound_ms"], "launch_path": m["enc_path"],
         "ms_64_blocks": m["enc64_ms"], "path_64_blocks": m["enc64_path"],
         "ms_64_blocks_dict": m["enc64_dict_ms"], **b1_resources(),
         **common},
        {"name": "B2 decode_serial",
         "source": "lz4_tpu_torch/csrc/decode_serial.cu",
         "replaces": "lz4_tpu/block/decode_pallas.py:74",
         "launches": m["b2_launches"]["B2"],
         "path": "main, wave_decode off",
         "max_abs_err": max(dec_err, m["dec_err"]),
         "ms": m["dec_ms"], "plain_ms": m["plain_dec_ms"],
         "bound_ms": m["dec_bound_ms"], **b2_resources(m["b2_per_call"]),
         "piece_waves": big["waves"], "piece_launches": big["launches"],
         "piece_ms": big["ms"], "piece_waves_ms": big["waves_ms"],
         **common},
        {"name": "B3 decode_wave",
         "source": "lz4_tpu_torch/csrc/decode_wave.cu",
         "replaces": "lz4_tpu/block/decode_wave.py:82",
         "launches": m["launches"]["B3"], "path": "main",
         "max_abs_err": max(wave_err, m["wave_err"]),
         "ms": m["wave_ms"], "plain_ms": m["plain_wave_ms"],
         "bound_ms": m["wave_bound_ms"], **b3_resources(m["b3_per_call"]),
         **common},
        {"name": "B4 encode_wave",
         "source": "lz4_tpu_torch/csrc/encode_wave.cu",
         "replaces": "lz4_tpu/block/encode_wave.py:94",
         "launches": md["launches"]["B4"], "path": "max_dist",
         "max_abs_err": max(match_err, md["err"]),
         "ms": md["ms"], "plain_ms": md["plain_ms"],
         "bound_ms": md["bound_ms"], **b4_resources(), **common},
        {"name": "B5 encode_hc",
         "source": "lz4_tpu_torch/csrc/encode_hc.cu",
         "replaces": "lz4_tpu/block/encode_hc_pallas.py:67",
         "launches": hc[9]["launches"]["B5"], "path": "hc, level 9",
         "max_abs_err": max(hc_err, hc[9]["err"], hc[3]["err"]),
         "ms": hc[9]["ms"], "plain_ms": hc[9]["plain_ms"],
         "bound_ms": hc[9]["bound_ms"], "level3_ms": hc[3]["ms"],
         "level3_launches": hc[3]["launches"]["B5"],
         "level3_plain_ms": hc[3]["plain_ms"],
         "level3_bound_ms": hc[3]["bound_ms"], "ms_64": hc[9]["ms_64"],
         "width_64": hc[9]["width_64"], "level3_ms_64": hc[3]["ms_64"],
         "clusters": hc[9]["clusters"], **b5_resources(),
         **common, "plain_blocks": hc[9]["plain_rows"]},
        {"name": "B6 xxh32",
         "source": "lz4_tpu_torch/csrc/xxh32.cu",
         "replaces": "lz4_tpu/xxh32_device.py:90",
         "launches": bench_launches["B6"], "path": "bench",
         "max_abs_err": max(xxh_err, hc["xxh"]["err"]),
         **{k: v for k, v in hc["xxh"].items() if k != "err"},
         "ms_4mb_row": xxh_4mb_ms, **common},
    ]
    for k in kernels:
        key = k["name"].split()[0]
        k["one_shot_launches"] = one_shot[key]
        k["example_launches"] = example_launches[key]
        k["torture_launches"] = torture_launches[key]
    for e in probes:
        e["torture_launches"] = torture_launches[e["source"]]
    print(json.dumps(chains), flush=True)
    print(json.dumps({"kernels": kernels + probes}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
