"""Cost split of kernel B6 (`csrc/xxh32.cu`) on the card.

    python -m lz4_tpu_torch.probes.b6_split [--mb 48] [--runs 10]
        [--variant NAME=DEFINE[,DEFINE...] ...]

Builds the kernel as it ships and variants of it, each with `-D`
defines, and times each with CUDA events on the main path's batch (the
real-file corpus in 64 KB blocks, every row full), best of `--runs`
after a warm-up, with the timers of `chip_smoke.py` (`probes/_timing.py`):
one launch after a sync (`ms`, the method of every kernel's `ms` in its
`kernels` line), the mean of 20 launches back to back
(`ms_back_to_back`, the L2 warm) and one launch with the L2 flushed
(`ms_l2_flushed`):

- `full`: the kernel as it ships;
- `loads` (`LZ4T_B6_LOADS_ONLY`): the ring filled as in `full`, each
  stage XOR-folded instead of hashed: the byte time;
- `chain` (`LZ4T_B6_CHAIN_ONLY`): no copies, every row's rounds on a
  lane constant: the two-instruction chain alone, the chain floor on
  this card;
- `row_thread` (`LZ4T_B6_ROW_THREAD`): the first design, one thread per
  row (CTAs of 128 threads);
- `count` (`LZ4T_B6_CYCLES`): `full` with `clock64` counters; each
  hashing warp writes, in place of its first hashes, the SM cycles of its
  waits on the stages' full barriers, its rounds and its releases of the
  stages (`cycles_per_chunk`: the mean over every chunk of every warp;
  `count_chain` the same of `chain`, and any `--variant` with
  `LZ4T_B6_CYCLES`).

`full` is checked against the host C XXH32 of every row, and every
other build that computes the hash (`row_thread`, each `--variant`
without `LZ4T_B6_LOADS_ONLY`, `LZ4T_B6_CHAIN_ONLY` or `LZ4T_B6_CYCLES`)
against `full` (`same_as_full`). One 4 MB row (`B` = 1) is timed for
`full` and `chain`: its chain alone sets its time. Prints one JSON line with the ms of each, each build's grid,
threads and dynamic shared memory, the SM clock, the rounds a row's
chain takes, and nvcc's register report.
Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.probes._timing import (FLUSH_BYTES, cuda_ms,
                                          cuda_ms_back_to_back,
                                          cuda_ms_flushed)
from lz4_tpu_torch.utils.realcorpus import real_corpus
from lz4_tpu_torch.xxh32 import xxh32_batch

BLOCK = 65536
LONG_ROW = 4 << 20
VARIANTS = {"full": (), "loads": ("LZ4T_B6_LOADS_ONLY",),
            "chain": ("LZ4T_B6_CHAIN_ONLY",),
            "row_thread": ("LZ4T_B6_ROW_THREAD",),
            "count": ("LZ4T_B6_CYCLES",),
            "count_chain": ("LZ4T_B6_CHAIN_ONLY", "LZ4T_B6_CYCLES")}
NOT_THE_HASH = ("LZ4T_B6_LOADS_ONLY", "LZ4T_B6_CHAIN_ONLY")


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _launcher(fn, data, lens):
    B, cap = data.shape
    out = torch.empty(B, dtype=torch.int64, device=data.device)

    def run():
        rc = fn(data.data_ptr(), lens.data_ptr(), out.data_ptr(), B, cap, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B6 variant launch failed: CUDA error {rc}")
    return run, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DEFINE[,DEFINE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b6_split: no CUDA device", file=sys.stderr)
        return 2
    extra = {}
    for v in args.variant:
        name, _, defs = v.partition("=")
        extra[name] = tuple(d for d in defs.split(",") if d)
    builds = {**VARIANTS, **extra}
    with ThreadPoolExecutor(len(builds)) as ex:   # one nvcc each, together
        list(ex.map(lambda d: _build.build(["xxh32"], d), builds.values()))

    corpus = real_corpus(args.mb << 20)
    B = len(corpus) // BLOCK
    host = np.frombuffer(corpus[: B * BLOCK], np.uint8).reshape(B, BLOCK)
    lens_h = np.full(B, BLOCK, np.int32)
    data, lens = torch.from_numpy(host).cuda(), torch.from_numpy(lens_h).cuda()
    want = torch.from_numpy(xxh32_batch(host, lens_h).astype(np.int64))
    rng = np.random.default_rng(8)
    long_h = rng.integers(0, 256, (1, LONG_ROW), dtype=np.uint8)
    long_d = torch.from_numpy(long_h).cuda()
    long_lens = torch.tensor([LONG_ROW], dtype=torch.int32, device="cuda")
    long_want = int(xxh32_batch(long_h, [LONG_ROW])[0])
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    ms, b2b, cold, shape, same, regs, cycles = {}, {}, {}, {}, {}, {}, {}
    ref = None
    for name, defs in builds.items():
        fn = _build.load("xxh32", defs)
        lib = ctypes.CDLL(_build.library_path("xxh32", defs))
        shape[name] = {"grid": int(lib.lz4t_xxh32_grid(B)),
                       "threads": int(lib.lz4t_xxh32_threads()),
                       "dynamic_smem": int(lib.lz4t_xxh32_smem())}
        run, out = _launcher(fn, data, lens)
        ms[name] = cuda_ms(run, args.runs)
        b2b[name] = cuda_ms_back_to_back(run, runs=args.runs)
        cold[name] = cuda_ms_flushed(run, args.runs, flush)
        run()
        torch.cuda.synchronize()
        if name == "full":
            ref = out.cpu()
            if not torch.equal(ref, want):
                bad = (ref != want).nonzero().flatten().tolist()
                raise AssertionError(f"B6 differs from host XXH32 in rows "
                                     f"{bad[:8]}")
        elif "LZ4T_B6_CYCLES" in defs:
            c = out.cpu().reshape(-1, 8)[:, :4].double().sum(0)
            cycles[name] = dict(zip(("wait", "rounds", "release"),
                                    [round(float(v / c[3]), 1)
                                     for v in c[:3]]))
        elif not set(defs) & set(NOT_THE_HASH):
            same[name] = torch.equal(out.cpu(), ref)
        if name in ("full", "chain"):
            run, out = _launcher(fn, long_d, long_lens)
            ms[f"{name}_4mb_row"] = cuda_ms(run, 3)
            if name == "full" and int(out[0]) != long_want:
                raise AssertionError("B6 differs from host XXH32 on a 4 MB "
                                     "row")
        regs[name] = [ln.strip() for ln in
                      _build.build_log("xxh32", defs).splitlines()
                      if "registers" in ln or "spill" in ln or "smem" in ln]
    print(json.dumps({
        "probe": "b6_split", "card": _smi("name,power.limit"),
        "clocks_sm": _smi("clocks.sm,clocks.max.sm"),
        "device": torch.cuda.get_device_name(0),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "blocks": B, "block": BLOCK, "bytes": B * BLOCK,
        "rounds_per_row": BLOCK // 16, "rounds_4mb_row": LONG_ROW // 16,
        "ms": ms, "ms_back_to_back": b2b, "ms_l2_flushed": cold,
        "launch": shape,
        "same_as_full": same, "cycles_per_chunk": cycles,
        "ptxas": regs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
