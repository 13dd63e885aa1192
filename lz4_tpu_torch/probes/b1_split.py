"""Cost split of kernel B1 (`csrc/encode_serial.cu`) on the card.

    python -m lz4_tpu_torch.probes.b1_split [--mb 48] [--runs 5]
        [--variant NAME=DEFINE[,DEFINE...] ...]
        [--corpus NAME --blocks 64[,N...] [--batches 4] [--seed 1]
         [--linked [--far one|all [--far-fill zero|random]]]]

Builds the kernel as it ships and three variants of it, each with a `-D`
define, and times each on the main-path batch (the real-file corpus in
64 KB blocks, no dict) with CUDA events, best of `--runs` after a
warm-up:

- `full`: the kernel as it ships;
- `nolits` (`LZ4T_B1_NOLITS`): literal bytes are not copied, the output
  position still advances;
- `noemit` (`LZ4T_B1_NOEMIT`): nothing is written to the output (on the
  solo path the parse warp hands no sequence over either);
- `nosrch` (`LZ4T_B1_NOSRCH`): no hash search, a match is forced 16
  bytes after each anchor with its candidate 16 bytes back (back
  extension, forward count and emission run; the stream is not valid).

Each `--variant` adds a build with other defines (a design
experiment), timed in both modes and checked byte for byte against
`full` (`same_as_full`). It also times `full` in dict mode on the same
blocks, each with the 64 KB before it as history (the engine's linked
segments). The
differences read as: full - nolits = literal copies, nolits - noemit =
the rest of the emission, full - nosrch = the search beyond what a
16-byte sequence costs.

With `--corpus`, the batches are instead the first `--batches` calls of
each `--blocks` count of a benchmark corpus (`benchmark/corpora/
<NAME>.json`, made from `--seed` on the card, in the benchmark's batch
order: `--corpus silesia-like --blocks 64` is the `lz4-64k.compress`
cell's call), each timed on every build, and `full` in dict mode with
each block's predecessor in the corpus as its history. With `--linked`
the corpus is made in rows of 128 KB, and each block is its row's second
half with the first half as its history: `--corpus silesia-like
--blocks 64 --linked` is the `lz4f-linked-64k.compress` cell's call,
whose history the block repeats (a predecessor is unrelated data), and
the batches without a history are the same blocks. The four builds
above are built a second time with `LZ4T_B1_SOLO_WAVES=0`
(`<name>_tables`), whose launches all take the device-table path, so the
kernel's two launch shapes are timed at the same B and held to each
other (`LZ4T_B1_SOLO_WAVES=2` as a `--variant` takes the solo path up to
two blocks an SM: the crossover); every build reports the path its
launches took (`solo` or `tables`, its `lz4t_encode_serial_plan`). In
dict mode two more builds run: `nopre` (`LZ4T_B1_NOPRE`, no history
pre-insert: full - nopre is the pre-insert's cost; the stream is not
valid), timed beside `full`, and `count` (`LZ4T_B1_COUNT`), held to
`full` byte for byte, whose figures of a solo launch (`counts_dict`: the
parse warp's reads of the window's history and of its block bytes, the
blocks whose parse left the window, going on with the row staged and
the history in device memory, and the bytes staged) say how far the
window served the search. `--far one` (`all`) plants a stretch of
FAR_LEN bytes at FAR_AT in the first block of each batch (in every
block): zeros, one match, or random bytes from the seed, one literal
run, each longer than the window's lead (the literal run's block leaves
the window).

Prints one JSON line. Needs one CUDA GPU and
nvcc; it is the port's counterpart of the TPU probe
`tools/session_r3g.py`.
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
from lz4_tpu_torch.block.batch import DICT_CAP, pack_blocks, to_device_batch
from lz4_tpu_torch.constants import compress_bound
from lz4_tpu_torch.utils.realcorpus import real_corpus

BLOCK = 65536
VARIANTS = {"full": (), "nolits": ("LZ4T_B1_NOLITS",),
            "noemit": ("LZ4T_B1_NOEMIT",), "nosrch": ("LZ4T_B1_NOSRCH",)}
TABLES = "LZ4T_B1_SOLO_WAVES=0"
#: dict mode's extra builds in the batch mode
DICT_BUILDS = {"nopre": ("LZ4T_B1_NOPRE",), "count": ("LZ4T_B1_COUNT",)}
COUNTS = ("hist_reads", "block_reads", "left", "staged")
#: `--far`: where the stretch lies in a block, and its length
FAR_AT, FAR_LEN = 32768, 12288


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _launcher(fn, src, lens, dic, dlens):
    B, cap = src.shape
    bound = compress_bound(cap)
    out = torch.empty((B, bound), dtype=torch.uint8, device=src.device)
    cs = torch.empty(B, dtype=torch.int32, device=src.device)
    tr = torch.empty(B, dtype=torch.int32, device=src.device)
    has = dic is not None

    def run():
        rc = fn(src.data_ptr(), lens.data_ptr(),
                dic.data_ptr() if has else None,
                dlens.data_ptr() if has else None, out.data_ptr(),
                cs.data_ptr(), tr.data_ptr(), B, cap, bound, int(has), 1, 3,
                65535, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B1 variant launch failed: CUDA error {rc}")
    return run, (out, cs, tr)


def _same(a, b) -> bool:
    """Equal csizes, trailing and out[:csizes] of two runs."""
    (oa, ca, ta), (ob, cb, tb) = a, b
    if not (torch.equal(ca, cb) and torch.equal(ta, tb)):
        return False
    live = torch.arange(oa.shape[1], device=oa.device)[None, :] < ca[:, None]
    return torch.equal(oa[live], ob[live])


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


def _regs(defs) -> list[str]:
    return [ln.strip() for ln in
            _build.build_log("encode_serial", defs).splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def path_of(defs, B: int, has_dict: bool) -> str:
    """The path a launch of B blocks takes in the build with `defines`:
    `solo` or `tables`, as its `lz4t_encode_serial_plan` says."""
    fn = ctypes.CDLL(_build.library_path(
        "encode_serial", defs)).lz4t_encode_serial_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    solo, sms = ctypes.c_int(), ctypes.c_int()
    rc = fn(int(B), int(has_dict), ctypes.byref(solo), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"B1 plan failed: CUDA error {rc}")
    return "solo" if solo.value else "tables"


def read_counts(defs, B: int, per_block: bool = False) -> dict:
    """The counting build's figures of its last dict solo launch of B
    blocks (COUNTS), summed over the blocks; with per_block, also
    `blocks`: each block's four figures."""
    fn = ctypes.CDLL(_build.library_path(
        "encode_serial", defs)).lz4t_encode_serial_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (4 * B))()
    torch.cuda.synchronize()
    rc = fn(buf, B)
    if rc != 0:
        raise RuntimeError(f"B1 counts failed: CUDA error {rc}")
    out = {k: sum(buf[4 * i + j] for i in range(B))
           for j, k in enumerate(COUNTS)}
    if per_block:
        out["blocks"] = [tuple(buf[4 * i: 4 * i + 4]) for i in range(B)]
    return out


def corpus_batches(name: str, blocks: int, batches: int, seed: int,
                   history: bool = False, device="cuda",
                   linked: bool = False):
    """The first `batches` calls of `blocks` 64 KB blocks of a benchmark
    corpus, in the benchmark's batch order, as (src, lens) on `device`;
    with `history`, (src, lens, dict_bufs, dict_lens) where each block's
    history is the corpus block before it (none for the first). With
    `linked` the corpus rows are 128 KB: a block is its row's second
    half, and its history (with `history`) the row's first half."""
    from benchmark import corpus
    spec = corpus.load_spec(name)
    stratum = spec["stratum_blocks"]
    n = -(-blocks * batches // stratum) * stratum
    data, _ = corpus.make_corpus(spec, seed, n, 2 * BLOCK if linked
                                 else BLOCK, device)
    lens = torch.full((blocks,), BLOCK, dtype=torch.int32, device=device)
    out = []
    for k in range(batches):
        rows = slice(k * blocks, (k + 1) * blocks)
        if linked:
            src = data[rows, BLOCK:].contiguous()
            out.append((src, lens, data[rows, :BLOCK].contiguous(),
                        torch.full_like(lens, DICT_CAP)) if history
                       else (src, lens))
            continue
        if not history:
            out.append((data[rows].contiguous(), lens))
            continue
        prev = torch.arange(k * blocks - 1, (k + 1) * blocks - 1,
                            device=device)
        dlens = torch.where(prev >= 0, DICT_CAP, 0).to(torch.int32)
        out.append((data[rows].contiguous(), lens,
                    data[prev.clamp(min=0)].contiguous(), dlens))
    return out


def plant_far(batches, blocks: str, fill: str, seed: int) -> None:
    """`--far`: FAR_LEN bytes at FAR_AT of the first block of each batch
    (blocks "one") or of every block ("all"), zeros or random bytes from
    `seed`, in place."""
    g = torch.Generator().manual_seed(seed)
    for src, *_ in batches:
        rows = src[:1] if blocks == "one" else src
        span = slice(FAR_AT, FAR_AT + FAR_LEN)
        if fill == "zero":
            rows[:, span] = 0
        else:
            rows[:, span] = torch.randint(
                0, 256, (rows.shape[0], FAR_LEN), generator=g,
                dtype=torch.uint8).to(src.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DEFINE[,DEFINE...]")
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--blocks", default="64")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--linked", action="store_true")
    ap.add_argument("--far", choices=("one", "all"), default=None)
    ap.add_argument("--far-fill", choices=("zero", "random"),
                    default="zero")
    args = ap.parse_args(argv)
    if args.linked and not args.corpus:
        ap.error("--linked needs --corpus")
    if args.far and not args.linked:
        ap.error("--far needs --linked")
    if not torch.cuda.is_available():
        print("b1_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {}
    for v in args.variant:
        name, _, defs = v.partition("=")
        extra[name] = tuple(d for d in defs.split(",") if d)
    builds = {**VARIANTS, **extra}
    if args.corpus:
        return main_batches(args, builds, extra)
    data = real_corpus(args.mb << 20)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    prefixes = [data[max(0, i - DICT_CAP): i] or None
                for i in range(0, len(data), BLOCK)]
    src, lens, _, _ = to_device_batch(*pack_blocks(blocks, cap=BLOCK),
                                      device="cuda")
    dict_batch = to_device_batch(
        *pack_blocks(blocks, prefixes, cap=BLOCK, with_dict=True),
        device="cuda")
    with ThreadPoolExecutor(len(builds)) as ex:   # one nvcc each, together
        list(ex.map(lambda d: _build.build(["encode_serial"], d),
                    builds.values()))
    res, csum, regs, same = {}, {}, {}, {}
    for dict_mode in (False, True):
        ref = None
        for name, defs in builds.items():
            if dict_mode and name != "full" and name not in extra:
                continue
            key = f"{name}_dict" if dict_mode else name
            fn = _build.load("encode_serial", defs)
            run, outs = _launcher(fn, *(dict_batch if dict_mode
                                        else (src, lens, None, None)))
            res[key] = _best_ms(run, args.runs)
            csum[key] = int(outs[1].sum())
            if name == "full":
                ref = outs
            elif name in extra:
                same[key] = _same(outs, ref)
            regs[name] = _regs(defs)
    print(json.dumps({
        "probe": "b1_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "blocks": len(blocks),
        "block": BLOCK, "bytes": len(data), "ms": res, "csize_sum": csum,
        "same_as_full": same, "ptxas": regs}), flush=True)
    return 0


def main_batches(args, builds, extra) -> int:
    """The batch mode (`--corpus`): each batch of each size timed on every
    build, the four of `VARIANTS` on both paths."""
    builds = {**builds, **{f"{k}_tables": (TABLES,) + d
                           for k, d in VARIANTS.items()}, **DICT_BUILDS}
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda d: _build.build(["encode_serial"], d),
                    builds.values()))
    checked = {"full_tables", "count", *extra}
    runs, same, mean = [], {}, {}
    for B in (int(x) for x in args.blocks.split(",")):
        batches = corpus_batches(args.corpus, B, args.batches, args.seed,
                                 history=True, linked=args.linked)
        if args.far:
            plant_far(batches, args.far, args.far_fill, args.seed)
        for k, (src, lens, dic, dlens) in enumerate(batches):
            row = {"blocks": B, "batch": k, "ms": {}, "ms_dict": {},
                   "path": {}, "path_dict": {}}
            for dict_mode in (False, True):
                ref = None
                for name, defs in builds.items():
                    if (name not in ("full", "nopre", *checked)
                            if dict_mode else name in DICT_BUILDS):
                        continue
                    batch = (src, lens, dic, dlens) if dict_mode else (
                        src, lens, None, None)
                    run, outs = _launcher(_build.load("encode_serial", defs),
                                          *batch)
                    sfx = "_dict" if dict_mode else ""
                    row["path" + sfx][name] = path_of(defs, B, dict_mode)
                    if name == "count":
                        run()
                        if row["path_dict"][name] == "solo":
                            row["counts_dict"] = read_counts(defs, B)
                    else:
                        row["ms" + sfx][name] = _best_ms(run, args.runs)
                    if name == "full":
                        ref = outs
                        row["csize_sum" + sfx] = int(outs[1].sum())
                    elif name in checked:
                        same[f"{name}{sfx}_B{B}_b{k}"] = _same(outs, ref)
            runs.append(row)
        for key in ("ms", "ms_dict"):
            rows = [r[key] for r in runs if r["blocks"] == B]
            mean[f"{key}_B{B}"] = {n: sum(r[n] for r in rows) / len(rows)
                                   for n in rows[0]}
        counted = [r["counts_dict"] for r in runs
                   if r["blocks"] == B and "counts_dict" in r]
        if counted:
            mean[f"counts_dict_B{B}"] = {
                k: sum(c[k] for c in counted) for k in COUNTS}
    print(json.dumps({
        "probe": "b1_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "corpus": args.corpus,
        "linked": args.linked, "far": args.far and [args.far, args.far_fill],
        "seed": args.seed, "block": BLOCK,
        "mean_ms": mean,
        "same_as_full": same, "runs": runs,
        "ptxas": {n: _regs(d) for n, d in builds.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
