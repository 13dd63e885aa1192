"""Cost split of kernel B4 (`csrc/encode_wave.cu`) on the card.

    python -m lz4_tpu_torch.probes.b4_split [--mb 48] [--runs 5]
        [--max-dist 2048] [--variant NAME=DEFINE[,DEFINE...] ...]

Builds the kernel as it ships and two variants of it, each with a
`-D` define, and times each on the `max_dist` path's batch (the
real-file corpus in 64 KB blocks, no history) with CUDA events, best of
`--runs` after a warm-up, at hash_bits 10 (the path's), 9 (`--fast`)
and 15:

- `full`: the kernel as it ships (the row read through L1);
- `probe` (`LZ4T_B4_PROBE_ONLY`): the probe and insert of every position
  only, no match machine (its output is not a decision array);
- `count` (`LZ4T_B4_CYCLES`): the kernel with `clock64` counters; each
  block writes, in place of its first decisions, the SM cycles of its
  probe and insert, its start pre-check and its match machine, and the
  machine's rounds (`cycles_per_step`: the mean over the warp steps of
  all blocks, at each hash_bits).

`full - probe` reads as the match machine's cost. Each `--variant` adds
a build with other defines, checked decision for decision against
`full` (`same_as_full`).
Linked mode (each block with the `history_rows` tail of the corpus
before it as history) is timed for `full`. Prints one JSON line with the
ms of each, the decisions written, the counts and nvcc's register
report. Needs one CUDA GPU and nvcc; it is the port's counterpart of the
TPU probe entry for B4 (ROADMAP B7).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block import encode_wave
from lz4_tpu_torch.utils.realcorpus import real_corpus

BLOCK = 65536
VARIANTS = {"full": (), "probe": ("LZ4T_B4_PROBE_ONLY",),
            "count": ("LZ4T_B4_CYCLES",)}
HASH_BITS = (10, 9, 15)


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _launcher(fn, inp, lens, hist, hlen, max_dist, hash_bits):
    B, row = inp.shape
    dec = torch.zeros((B, row // 4), dtype=torch.int32, device=inp.device)
    wr = 0 if hist is None else hist.shape[1] // 4

    def run():
        dec.zero_()
        rc = fn(inp.data_ptr(), lens.data_ptr(),
                None if hist is None else hist.data_ptr(),
                None if hlen is None else hlen.data_ptr(), dec.data_ptr(),
                B, row // 4, wr, max_dist, hash_bits,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B4 variant launch failed: CUDA error {rc}")
    return run, dec


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--max-dist", type=int, default=2048)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DEFINE[,DEFINE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b4_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {}
    for v in args.variant:
        name, _, defs = v.partition("=")
        extra[name] = tuple(d for d in defs.split(",") if d)
    builds = {**VARIANTS, **extra}
    data = real_corpus(args.mb << 20)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    n_rows = encode_wave.rows_for(BLOCK)
    inp, lens = (torch.from_numpy(a).cuda()
                 for a in encode_wave.pack_input(blocks, n_rows))
    # linked: each block sees the tail of the corpus before it
    wr = encode_wave.history_rows(args.max_dist, n_rows)
    hist, hlen = (torch.from_numpy(a).cuda() for a in encode_wave.pack_history(
        [blocks[:t] + [b""] for t in range(len(blocks))],
        len(blocks) - 1, wr))
    with ThreadPoolExecutor(len(builds)) as ex:   # one nvcc each, together
        list(ex.map(lambda d: _build.build(["encode_wave"], d),
                    builds.values()))
    res, written, regs, same, cycles = {}, {}, {}, {}, {}
    for hb in HASH_BITS:
        ref = None
        for name, defs in builds.items():
            fn = _build.load("encode_wave", defs)
            run, dec = _launcher(fn, inp, lens, None, None, args.max_dist, hb)
            key = f"{name}_hb{hb}"
            res[key] = _best_ms(run, args.runs)
            written[key] = int((dec != 0).sum())
            if name == "full":
                ref = dec.clone()
            elif name == "count":
                steps = (lens.long() + 31) // 32
                c = dec[:, :4].long()
                c[:, :3] *= 16
                per = c.sum(0).double() / steps.sum().double()
                cycles[key] = dict(zip(
                    ("insert", "check", "machine", "rounds"),
                    [round(float(v), 2) for v in per]))
            elif name != "probe":
                same[key] = torch.equal(dec, ref)
            regs[name] = [ln.strip() for ln in
                          _build.build_log("encode_wave", defs).splitlines()
                          if "registers" in ln or "spill" in ln]
    fn = _build.load("encode_wave")
    run, dec = _launcher(fn, inp, lens, hist, hlen, args.max_dist, 10)
    res["full_linked_hb10"] = _best_ms(run, args.runs)
    written["full_linked_hb10"] = int((dec != 0).sum())
    print(json.dumps({
        "probe": "b4_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "blocks": len(blocks),
        "block": BLOCK, "bytes": len(data), "max_dist": args.max_dist,
        "ms": res, "decisions": written, "same_as_full": same,
        "cycles_per_step": cycles,
        "ptxas": regs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
