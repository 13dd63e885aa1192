"""Cost split of kernel B1 (`csrc/encode_serial.cu`) on the card.

    python -m lz4_tpu_torch.probes.b1_split [--mb 48] [--runs 5]
        [--variant NAME=DEFINE[,DEFINE...] ...]

Builds the kernel as it ships and three variants of it, each with a `-D`
define, and times each on the main-path batch (the real-file corpus in
64 KB blocks, no dict) with CUDA events, best of `--runs` after a
warm-up:

- `full`: the kernel as it ships;
- `nolits` (`LZ4T_B1_NOLITS`): literal bytes are not copied, the output
  position still advances;
- `noemit` (`LZ4T_B1_NOEMIT`): nothing is written to the output;
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
16-byte sequence costs. Prints one JSON line. Needs one CUDA GPU and
nvcc; it is the port's counterpart of the TPU probe
`tools/session_r3g.py`.
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DEFINE[,DEFINE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {}
    for v in args.variant:
        name, _, defs = v.partition("=")
        extra[name] = tuple(d for d in defs.split(",") if d)
    builds = {**VARIANTS, **extra}
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
            regs[name] = [ln.strip() for ln in
                          _build.build_log("encode_serial", defs).splitlines()
                          if "registers" in ln or "spill" in ln]
    print(json.dumps({
        "probe": "b1_split", "card": _card(),
        "device": torch.cuda.get_device_name(0), "blocks": len(blocks),
        "block": BLOCK, "bytes": len(data), "ms": res, "csize_sum": csum,
        "same_as_full": same, "ptxas": regs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
