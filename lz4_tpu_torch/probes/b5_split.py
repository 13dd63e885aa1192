"""Cost split of kernel B5 (`csrc/encode_hc.cu`) on the card.

    python -m lz4_tpu_torch.probes.b5_split [--mb 48] [--runs 3]
        [--levels 3,9] [--variant NAME=DEFINE[,DEFINE...] ...]
        [--corpus NAME --blocks 64 [--batches 8] [--seed 1]
         [--per-block FILE]]

Builds the kernel as it ships and variants of it, each with a `-D`
define, and times each at every level on the main-path batch of the HC
path (the real-file corpus in 64 KB blocks, no dict) with CUDA events,
best of `--runs` after a warm-up. With `--corpus`, the batches are
instead the first `--batches` calls of `--blocks` blocks of a benchmark
corpus (`benchmark/corpora/<NAME>.json`, made from `--seed` on the card,
in the benchmark's batch order: `--corpus silesia-like --blocks 64` is
the `lz4hc9-64k.compress` cell's), one launch each:

- `full`: the kernel as it ships;
- `noemit` (`LZ4T_B5_NOEMIT`): nothing is written to the output, the
  output position still advances;
- `prepass` (`LZ4T_B5_PREPASS`): the set-up before the parse only (the
  chain-delta pre-pass and the row's copy into shared memory).

A counting build (`LZ4T_B5_COUNT`) writes, for every block, the
searches, the candidates visited on the chains, the candidates that pass
the can-beat filter and are scored in full, the bytes the counts
compared, the SM cycles (`clock64`) of the pre-pass, of the parses
(summed over the warps), their searches and full scores, of the whole
block and of the write-out, whether the block fell back to the serial
parse, the sequences the repairs made, the wall cycles of the
speculative parses, the repairs and the serial parse, and the width the
block ran at (the CTAs of its cluster), into a device buffer; the probe
reports their sums, the counts' rates per source byte, the cycles
per hop, per full score and per search outside the chain walk, and the
cycles per block. Each `--variant` adds a build with other defines (a
design experiment), timed at every level and checked byte for byte
against `full` (`same_as_full`). The differences read as: full - noemit
= the output writes, full - prepass = the parse and the write-out.
In the batch mode each batch also reports its launch's width and the
card's cluster count (`lz4t_encode_hc_plan`), its slowest block's cycles
by phase beside the batch's `full` ms, its fallbacks and its blocks'
mean cycles by phase; `--per-block` writes every block's counts as JSON
lines. Prints one JSON line. Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch
from lz4_tpu_torch.block.encode_hc import depth_for, plan
from lz4_tpu_torch.constants import compress_bound
from lz4_tpu_torch.probes.b1_split import (_best_ms, _card, _same,
                                            corpus_batches)
from lz4_tpu_torch.utils.realcorpus import real_corpus

BLOCK = 65536
VARIANTS = {"full": (), "noemit": ("LZ4T_B5_NOEMIT",),
            "prepass": ("LZ4T_B5_PREPASS",)}
COUNT = ("LZ4T_B5_COUNT",)
COUNT_KEYS = ("searches", "candidates", "scored", "bytes_compared",
              "cycles_prepass", "cycles_parse", "cycles_search",
              "cycles_score", "cycles_block", "fallbacks", "repaired",
              "cycles_writeout", "cycles_spec", "cycles_repair",
              "cycles_serial", "width")
PHASES = ("cycles_prepass", "cycles_spec", "cycles_repair", "cycles_serial",
          "cycles_writeout", "cycles_block")


def _launcher(fn, src, lens, level):
    B, cap = src.shape
    bound = compress_bound(cap)
    out = torch.empty((B, bound), dtype=torch.uint8, device=src.device)
    cs = torch.empty(B, dtype=torch.int32, device=src.device)
    tr = torch.empty(B, dtype=torch.int32, device=src.device)

    def run():
        rc = fn(src.data_ptr(), lens.data_ptr(), out.data_ptr(),
                cs.data_ptr(), tr.data_ptr(), B, cap, bound,
                depth_for(level), 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B5 variant launch failed: CUDA error {rc}")
    return run, (out, cs, tr)


def _block_counts(src, lens, level) -> torch.Tensor:
    """The counting build's counts of each block: int64[B, COUNT_KEYS]."""
    counts = torch.zeros((src.shape[0], len(COUNT_KEYS)), dtype=torch.int64,
                         device=src.device)
    fn = _build.load("encode_hc", COUNT)
    lib = ctypes.CDLL(_build.library_path("encode_hc", COUNT))
    lib.lz4t_encode_hc_counts.argtypes = [ctypes.c_void_p]
    lib.lz4t_encode_hc_counts.restype = None
    lib.lz4t_encode_hc_counts(counts.data_ptr())
    run, _ = _launcher(fn, src, lens, level)
    run()
    torch.cuda.synchronize()
    lib.lz4t_encode_hc_counts(None)
    return counts.cpu()


def _counts(src, lens, level) -> dict:
    """The counting build's per-block counts, summed over the batch."""
    counts = _block_counts(src, lens, level)
    total = int(lens.sum())
    c = dict(zip(COUNT_KEYS, counts.sum(0).tolist()))
    return {**c,
            **{f"{k}_per_byte": c[k] / total for k in COUNT_KEYS[:4]},
            "candidates_per_block_max": int(counts[:, 1].max()),
            # SM cycles: a hop outside full scores, a full score, the parse
            # outside searches per search, the pre-pass per block
            "cycles_per_hop": (c["cycles_search"] - c["cycles_score"])
            / max(c["candidates"], 1),
            "cycles_per_score": c["cycles_score"] / max(c["scored"], 1),
            "cycles_outside_search_per_search":
            (c["cycles_parse"] - c["cycles_search"]) / max(c["searches"], 1),
            "cycles_prepass_per_block": c["cycles_prepass"] / len(counts),
            "cycles_block_per_block": c["cycles_block"] / len(counts),
            "cycles_writeout_per_block": c["cycles_writeout"] / len(counts)}


def batch_report(k, src, lens, level, ms, per_block=None) -> dict:
    """One batch's launch: its width, its `full` ms, its slowest block's
    cycles by phase, its fallbacks and its blocks' mean cycles by phase."""
    counts = _block_counts(src, lens, level)
    rows = [dict(zip(COUNT_KEYS, r)) for r in counts.tolist()]
    if per_block is not None:
        for i, r in enumerate(rows):
            per_block.write(json.dumps({"batch": k, "level": level,
                                        "block": i, **r}) + "\n")
    slow = max(range(len(rows)), key=lambda i: rows[i]["cycles_block"])
    width, clusters = plan(len(rows))
    return {"batch": k, "level": level, "ms": ms, "width": width,
            "clusters": clusters,
            "count_width": rows[slow]["width"],
            "slowest_block": slow,
            "slowest": {p: rows[slow][p] for p in PHASES},
            "fallbacks": sum(r["fallbacks"] for r in rows),
            "mean": {p: sum(r[p] for r in rows) / len(rows)
                     for p in PHASES}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--levels", default="3,9")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DEFINE[,DEFINE...]")
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--per-block", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b5_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {}
    for v in args.variant:
        name, _, defs = v.partition("=")
        extra[name] = tuple(d for d in defs.split(",") if d)
    builds = {**VARIANTS, **extra, "count": COUNT}
    levels = [int(x) for x in args.levels.split(",")]
    if args.corpus:
        return main_batches(args, builds, levels)
    data = real_corpus(args.mb << 20)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    src, lens, _, _ = to_device_batch(*pack_blocks(blocks, cap=BLOCK),
                                      device="cuda")
    with ThreadPoolExecutor(len(builds)) as ex:   # one nvcc each, together
        list(ex.map(lambda d: _build.build(["encode_hc"], d),
                    builds.values()))
    res, csum, same, counts, regs = {}, {}, {}, {}, {}
    for level in levels:
        ref = None
        for name, defs in builds.items():
            if name == "count":
                continue
            key = f"{name}_l{level}"
            run, outs = _launcher(_build.load("encode_hc", defs), src, lens,
                                  level)
            res[key] = _best_ms(run, args.runs)
            csum[key] = int(outs[1].sum())
            if name == "full":
                ref = outs
            elif name in extra:
                same[key] = _same(outs, ref)
        counts[f"l{level}"] = _counts(src, lens, level)
    for name, defs in builds.items():
        regs[name] = [ln.strip() for ln in
                      _build.build_log("encode_hc", defs).splitlines()
                      if "registers" in ln or "spill" in ln
                      or "smem" in ln]
    print(json.dumps({
        "probe": "b5_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "blocks": len(blocks),
        "block": BLOCK, "bytes": len(data), "ms": res, "csize_sum": csum,
        "same_as_full": same, "counts": counts, "ptxas": regs}), flush=True)
    return 0


def main_batches(args, builds, levels) -> int:
    """The batch mode (`--corpus`): each batch timed at every level on
    every build, with its counting build's report."""
    batches = corpus_batches(args.corpus, args.blocks, args.batches,
                             args.seed)
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build(["encode_hc"], d),
                    builds.values()))
    reports, same = [], {}
    per_block = open(args.per_block, "w") if args.per_block else None
    try:
        for level in levels:
            for k, (src, lens) in enumerate(batches):
                ms, ref = {}, None
                for name, defs in builds.items():
                    if name == "count":
                        continue
                    run, outs = _launcher(_build.load("encode_hc", defs),
                                          src, lens, level)
                    ms[name] = _best_ms(run, args.runs)
                    if name == "full":
                        ref = outs
                    elif name not in VARIANTS:
                        same[f"{name}_b{k}_l{level}"] = _same(outs, ref)
                rep = batch_report(k, src, lens, level, ms["full"],
                                   per_block)
                reports.append({**rep, "ms_builds": ms})
    finally:
        if per_block is not None:
            per_block.close()
    print(json.dumps({
        "probe": "b5_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "corpus": args.corpus,
        "seed": args.seed, "blocks": args.blocks, "block": BLOCK,
        "batches": reports, "same_as_full": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
