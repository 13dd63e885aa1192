#!/usr/bin/env python3
"""Smoke run of the lz4_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from lz4_tpu_torch/csrc with nvcc, holds each
kernel against its plain PyTorch version on the card, drives the port's
main path (the fast-tier block round trip through `TorchBackend`) over a
48 MB real-file corpus in 64 KB blocks, then round-trips linked and
independent frames through the port's frame layer. Any failure raises.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a {"kernels": [...]} line.
Needs one CUDA GPU; exits non-zero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block import decode_cuda, encode_cuda
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch
from lz4_tpu_torch.frame.format import FrameInfo, Preferences
from lz4_tpu_torch.frame.reader import decompress_frame
from lz4_tpu_torch.frame.writer import compress_frame
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text
from lz4_tpu_torch.utils.realcorpus import describe, real_corpus

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BLOCK = 65536
CORPUS = 48 << 20
PLAIN_ROWS = 8


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=5):
    """Best of `runs` timings of fn() with CUDA events, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


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
    out, cs, _ = plain
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
    log("B1 == plain: dict mode, full and partial history")

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
    return enc_err, dec_err


def phase_main_path(be):
    data = real_corpus(CORPUS)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    log(f"main path: {describe(data)}, {len(blocks)} blocks of {BLOCK}")
    encode_cuda.launches = 0
    decode_cuda.launches = 0
    comp = be.compress_batch(blocks, level=1)
    back = be.decompress_batch(comp, [BLOCK] * len(blocks))
    launches = {"B1": encode_cuda.launches, "B2": decode_cuda.launches}
    if back != blocks:
        raise AssertionError("main path round trip differs from the source")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    csum = sum(len(c) for c in comp)
    log(f"main path round trip ok: ratio {len(data) / csum:.4f}, "
        f"launches {launches}")

    # end to end through TorchBackend (host packing and copies included)
    enc_ms = cuda_ms(lambda: be.compress_batch(blocks, level=1), runs=3)
    dec_ms = cuda_ms(lambda: be.decompress_batch(comp, [BLOCK] * len(blocks)),
                     runs=3)
    mb = len(data) / 1e6
    log(f"TorchBackend compress {mb / enc_ms * 1e3:.1f} MB/s "
        f"({enc_ms:.3f} ms), decompress {mb / dec_ms * 1e3:.1f} MB/s "
        f"({dec_ms:.3f} ms), ratio {len(data) / csum:.4f}")

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
                                      for i in range(len(blocks))])
    log("compress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    steps = {}
    arrays_d = stage(steps, "pack", lambda: pack_blocks(
        comp, cap=max(len(c) for c in comp)))
    dev_d = stage(steps, "h2d", lambda: to_device_batch(*arrays_d,
                                                        device="cuda"))
    dec = stage(steps, "B2", lambda: decode_cuda.decode_blocks(
        dev_d[0], dev_d[1], cap_out=BLOCK))
    host = stage(steps, "d2h", lambda: (dec[0].cpu().numpy(),
                                        dec[1].cpu().tolist(),
                                        dec[2].cpu().tolist()))
    stage(steps, "to_bytes", lambda: [host[0][i, : host[1][i]].tobytes()
                                      for i in range(len(blocks))])
    log("decompress steps (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))

    # the kernels alone on the main path's device-resident batches
    gpu_enc = encode_cuda.encode_blocks(src, lens, cap_n=BLOCK)
    k_enc = cuda_ms(lambda: encode_cuda.encode_blocks(src, lens, cap_n=BLOCK))
    comp_t, clens_t = dev_d[0], dev_d[1]
    k_dec = cuda_ms(lambda: decode_cuda.decode_blocks(comp_t, clens_t,
                                                      cap_out=BLOCK))
    gpu_dec = decode_cuda.decode_blocks(comp_t, clens_t, cap_out=BLOCK)
    log(f"kernel B1 {k_enc:.3f} ms ({mb / k_enc * 1e3:.1f} MB/s), "
        f"kernel B2 {k_dec:.3f} ms ({mb / k_dec * 1e3:.1f} MB/s) "
        f"on {len(blocks)} blocks")

    # plain versions on rows of the same batch
    rows = list(range(0, len(blocks), len(blocks) // 64))[:64]
    cpu = [t.cpu() for t in (src, lens)]
    plain_enc = encode_cuda.encode_blocks_plain(cpu[0][rows], cpu[1][rows],
                                                cap_n=BLOCK)
    enc_err = compare_encode(gpu_enc, plain_enc, rows)
    cpu_out, cpu_cs = comp_t.cpu(), clens_t.cpu()
    plain_dec = decode_cuda.decode_blocks_plain(cpu_out, cpu_cs,
                                                cap_out=BLOCK)
    dec_err = compare_decode(gpu_dec, plain_dec)
    log(f"B1 == plain on {len(rows)} main-path rows; "
        f"B2 == plain on all {len(blocks)} rows")
    r8 = rows[:PLAIN_ROWS]
    p_enc, _ = host_ms(lambda: encode_cuda.encode_blocks_plain(
        cpu[0][r8], cpu[1][r8], cap_n=BLOCK))
    p_dec, _ = host_ms(lambda: decode_cuda.decode_blocks_plain(
        cpu_out[r8], cpu_cs[r8], cap_out=BLOCK))
    log(f"plain B1 {p_enc:.1f} ms, plain B2 {p_dec:.1f} ms "
        f"on {PLAIN_ROWS} blocks")

    B = len(blocks)
    enc_bytes = len(data) + csum + B * 12     # src + lens in; out + 2 ints
    dec_bytes = csum + B * 4 + len(data) + B * 8
    return {
        "launches": launches, "enc_ms": k_enc, "dec_ms": k_dec,
        "plain_enc_ms": p_enc, "plain_dec_ms": p_dec,
        "enc_bound_ms": enc_bytes / HBM_BYTES_PER_S * 1e3,
        "dec_bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3,
        "enc_err": enc_err, "dec_err": dec_err, "blocks": B,
    }


def phase_frames(be):
    data = real_corpus(CORPUS)[: 16 << 20]
    for bsid, independent in ((7, False), (4, True)):
        before = (encode_cuda.launches, decode_cuda.launches)
        prefs = Preferences(frame_info=FrameInfo(
            block_size_id=bsid, block_independent=independent,
            block_checksum=True, content_checksum=True))
        t_c, frame = host_ms(lambda: compress_frame(data, prefs=prefs,
                                                    backend=be))
        t_d, back = host_ms(lambda: decompress_frame(frame, backend=be))
        if back != data:
            raise AssertionError(f"frame round trip failed (bsid {bsid})")
        after = (encode_cuda.launches, decode_cuda.launches)
        if not (after[0] > before[0] and after[1] > before[1]):
            raise AssertionError(f"frame path skipped a kernel: {before} "
                                 f"-> {after}")
        kind = "independent" if independent else "linked"
        log(f"frame ok: 16 MB, {kind} {FrameInfo(block_size_id=bsid).block_max_size >> 10} KB "
            f"blocks, ratio {len(data) / len(frame):.4f}, compress "
            f"{t_c:.1f} ms, decompress {t_d:.1f} ms (host clock, "
            f"checksums in Python)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind}")

    secs = _build.build()
    log("build seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    enc_err, dec_err = phase_kernels_vs_plain()
    be = TorchBackend()
    m = phase_main_path(be)
    phase_frames(be)

    kernels = [
        {"name": "B1 encode_serial", "route": "cuda",
         "source": "lz4_tpu_torch/csrc/encode_serial.cu",
         "replaces": "lz4_tpu/block/encode_pallas.py:54",
         "launches": m["launches"]["B1"],
         "max_abs_err": max(enc_err, m["enc_err"]),
         "ms": m["enc_ms"], "plain_ms": m["plain_enc_ms"],
         "bound_ms": m["enc_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "blocks": m["blocks"],
         "plain_blocks": PLAIN_ROWS},
        {"name": "B2 decode_serial", "route": "cuda",
         "source": "lz4_tpu_torch/csrc/decode_serial.cu",
         "replaces": "lz4_tpu/block/decode_pallas.py:74",
         "launches": m["launches"]["B2"],
         "max_abs_err": max(dec_err, m["dec_err"]),
         "ms": m["dec_ms"], "plain_ms": m["plain_dec_ms"],
         "bound_ms": m["dec_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "blocks": m["blocks"],
         "plain_blocks": PLAIN_ROWS},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
