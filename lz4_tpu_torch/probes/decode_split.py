"""Cost split of the decoders B2 (`csrc/decode_serial.cu`) and B3
(`csrc/decode_wave.cu`) on the card.

    python -m lz4_tpu_torch.probes.decode_split [--mb 48] [--runs 5]
        [--variant b2:NAME=DEFINE[,DEFINE...] | b3:NAME=DEFINE[,...] ...]

Builds each kernel as it ships and variants of it, each with `-D`
defines, and times each with CUDA events (best of `--runs` after a
warm-up) on the main path's batch: the real-file corpus in 64 KB blocks,
compressed by `TorchBackend` at level 1 (B2 takes the streams, B3 the C
splitter's arenas of them).

B2 (the decode cost split of the TPU probe `tools/session_r3d.py:122`
and the parse-only run of `tools/session_r3f.py:98`):
- `full`: the kernel as it ships;
- `parse` (`LZ4T_B2_PARSE_ONLY`): the parse warp publishes every
  descriptor, the copy warps take them and copy nothing;
- `copies` (`LZ4T_B2_PROBE`, entry `lz4t_decode_serial_desc`): the
  descriptors of a first launch replayed from device memory, 32 a load,
  in place of the parse: the copies alone;
- `count` (`LZ4T_B2_CYCLES`): clock64 counters per block: the parse
  warp's SM cycles per sequence, the share of them spent rebuilding its
  lane records and the sequences per rebuild, the copy warps' waits for
  descriptors and for final source bytes; with the sequences per block;
- `full_4mb`: the kernel on four 4 MB blocks (the `decode_dest =
  "device"` route).

B3 (in the spirit of `tools/session_r4probe.py:83`):
- `full`: as it ships (phase A, then pointer jumping);
- `phase_a` (`LZ4T_B3_PARSE_ONLY`): the parse, the literals and the
  sources alone;
- `global` (`LZ4T_B3_GLOBAL`): the instantiation of streams over 64
  pieces (output in global memory, 32-bit sources in device scratch) at
  64 pieces: what the shared-memory tile saves;
- `count` (`LZ4T_B3_CYCLES`): the CTA's SM cycles in phase A (per
  stream, and per sequence of the stream) and in phase B, and the rounds
  of pointer jumping.

Every variant that decodes is checked against `full` (`same_as_full`).
Prints one JSON line with the card, the ms of each build, the counts
and nvcc's register report. Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block import decode_wave
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.batch import pack_blocks
from lz4_tpu_torch.native import blockcodec
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.realcorpus import real_corpus

BLOCK = 65536
B2 = {"full": (), "parse": ("LZ4T_B2_PARSE_ONLY",),
      "copies": ("LZ4T_B2_PROBE",), "count": ("LZ4T_B2_CYCLES",)}
B3 = {"full": (), "phase_a": ("LZ4T_B3_PARSE_ONLY",),
      "global": ("LZ4T_B3_GLOBAL",), "count": ("LZ4T_B3_CYCLES",)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _best_ms(run, runs):
    run()
    best = float("inf")
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def _regs(name, defs):
    return [ln.strip() for ln in _build.build_log(name, defs).splitlines()
            if "registers" in ln or "spill" in ln]


def _b2_launcher(fn, comp, lens, cap_out):
    B, cap_in = comp.shape
    out = torch.zeros((B, cap_out), dtype=torch.uint8, device=comp.device)
    olen = torch.zeros(B, dtype=torch.int32, device=comp.device)
    err = torch.zeros(B, dtype=torch.int32, device=comp.device)

    def run():
        rc = fn(comp.data_ptr(), lens.data_ptr(), None, None, out.data_ptr(),
                olen.data_ptr(), err.data_ptr(), B, cap_in, cap_out, 0, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B2 variant launch failed: CUDA error {rc}")
    return run, (out, olen, err)


def _same_b2(a, ref):
    out, olen, err = (x.cpu() for x in a)
    r_out, r_olen, r_err = (x.cpu() for x in ref)
    if not (torch.equal(olen, r_olen) and torch.equal(err, r_err)):
        return False
    return all(torch.equal(out[i, :n], r_out[i, :n])
               for i, n in enumerate(r_olen.tolist()) if not r_err[i])


def _b2_copies(defs, comp, lens, runs):
    """Dump the descriptors with one launch, then time their replay."""
    lib = ctypes.CDLL(_build.library_path("decode_serial", defs))
    fn = lib.lz4t_decode_serial_desc
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P]
    fn.restype = _I
    B, cap_in = comp.shape
    max_desc = BLOCK // 4 + 1
    gdesc = torch.zeros((B, max_desc, 2, 4), dtype=torch.int32,
                        device=comp.device)
    gcount = torch.zeros(B, dtype=torch.int32, device=comp.device)
    out = torch.zeros((B, BLOCK), dtype=torch.uint8, device=comp.device)
    olen = torch.zeros(B, dtype=torch.int32, device=comp.device)
    err = torch.zeros(B, dtype=torch.int32, device=comp.device)

    def call(mode):
        rc = fn(comp.data_ptr(), lens.data_ptr(), out.data_ptr(),
                olen.data_ptr(), err.data_ptr(), B, cap_in, BLOCK,
                gdesc.data_ptr(), gcount.data_ptr(), max_desc, mode,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B2 descriptor launch failed: CUDA error {rc}")
    call(1)
    torch.cuda.synchronize()
    ms = _best_ms(lambda: call(2), runs)
    return ms, (out, olen, err)


def probe_b2(comp, lens, big, runs, extra):
    builds = {**B2, **extra}
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build(["decode_serial"], d),
                    builds.values()))
    res, same, regs, counts = {}, {}, {}, {}
    ref = None
    for name, defs in builds.items():
        regs[name] = _regs("decode_serial", defs)
        if name == "copies":
            res[name], got = _b2_copies(defs, comp, lens, runs)
            same[name] = _same_b2(got, ref)
            continue
        run, got = _b2_launcher(_build.load("decode_serial", defs), comp,
                                lens, BLOCK)
        res[name] = _best_ms(run, runs)
        if name == "full":
            ref = tuple(x.clone() for x in got)
        elif "LZ4T_B2_CYCLES" in defs:
            c = got[0][:, :56].contiguous().view(torch.int64).double().cpu()
            n = c[:, 6]
            counts[name] = {
                "seqs_per_block_mean": float(n.mean()),
                "seqs_per_block_max": int(n.max()),
                "parse_cycles_per_seq": float(c[:, 0].sum() / n.sum()),
                "rebuild_share": float(c[:, 1].sum() / c[:, 0].sum()),
                "seqs_per_rebuild": float(n.sum() / c[:, 2].sum()),
                "copy_head_wait_share": float(c[:, 3].sum() / c[:, 5].sum()),
                "copy_source_wait_share": float(c[:, 4].sum()
                                                / c[:, 5].sum()),
            }
        elif name != "parse":
            same[name] = _same_b2(got, ref)
    # four 4 MB blocks
    bc, bl = big
    run, got = _b2_launcher(_build.load("decode_serial"), bc, bl, 4 << 20)
    res["full_4mb"] = _best_ms(run, max(1, runs // 2))
    ok = not bool(got[2].any())
    return {"ms": res, "same_as_full": same, "counts": counts,
            "ptxas": regs, "full_4mb_ok": ok}


def probe_b3(arenas, out_lens, runs, extra):
    builds = {**B3, **extra}
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build(["decode_wave"], d),
                    builds.values()))
    B, NP, _ = arenas.shape
    res, same, regs, counts = {}, {}, {}, {}
    ref = None
    n_l = out_lens.cpu().tolist()
    for name, defs in builds.items():
        regs[name] = _regs("decode_wave", defs)
        fn = _build.load("decode_wave", defs)
        out = torch.zeros((B, NP * decode_wave.WOUT), dtype=torch.uint8,
                          device=arenas.device)

        def run(fn=fn, out=out):
            rc = fn(arenas.data_ptr(), out_lens.data_ptr(), None,
                    out.data_ptr(), B, NP,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"B3 variant launch failed: CUDA error {rc}")
        res[name] = _best_ms(run, runs)
        if name == "full":
            ref = out.cpu()
        elif name == "count":
            c = out[:, :32].contiguous().view(torch.int64).double().cpu()
            counts = {
                "seqs_per_stream_mean": float(c[:, 2].mean()),
                "phase_a_cycles_mean": float(c[:, 0].mean()),
                "phase_a_cycles_per_seq": float(c[:, 0].sum()
                                                / c[:, 2].sum()),
                "phase_b_cycles_mean": float(c[:, 1].mean()),
                "rounds_mean": float(c[:, 3].mean()),
                "rounds_max": int(c[:, 3].max())}
        elif name != "phase_a":
            got = out.cpu()
            same[name] = all(torch.equal(got[i, :k], ref[i, :k])
                             for i, k in enumerate(n_l))
    return {"ms": res, "same_as_full": same, "counts": counts, "ptxas": regs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="b2|b3:NAME=DEFINE[,DEFINE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {"b2": {}, "b3": {}}
    for v in args.variant:
        kernel, _, rest = v.partition(":")
        name, _, defs = rest.partition("=")
        extra[kernel][name] = tuple(d for d in defs.split(",") if d)
    data = real_corpus(args.mb << 20)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    comp = TorchBackend().compress_batch(blocks, level=1)
    cap_in = -(-max(len(c) for c in comp) // 16) * 16
    src, lens, _, _ = pack_blocks(comp, cap=cap_in)
    comp_t, lens_t = torch.from_numpy(src).cuda(), torch.from_numpy(lens).cuda()
    big_src = [data[i: i + (4 << 20)] for i in range(0, 16 << 20, 4 << 20)]
    big = HostBackend().compress_batch(big_src)
    bsrc, blens, _, _ = pack_blocks(big, cap=-(-max(map(len, big)) // 16) * 16)
    b2 = probe_b2(comp_t, lens_t, (torch.from_numpy(bsrc).cuda(),
                                   torch.from_numpy(blens).cuda()),
                  args.runs, extra["b2"])
    arenas, out_lens = blockcodec.wave_split_batch(
        comp, max_pieces=64, out_caps=[BLOCK] * len(comp))
    b3 = probe_b3(torch.from_numpy(arenas).cuda(),
                  torch.from_numpy(out_lens).cuda(), args.runs, extra["b3"])
    print(json.dumps({
        "probe": "decode_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "blocks": len(blocks),
        "block": BLOCK, "bytes": len(data),
        "compressed_bytes": sum(len(c) for c in comp), "b2": b2, "b3": b3}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
