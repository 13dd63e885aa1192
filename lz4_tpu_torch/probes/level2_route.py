"""`TorchBackend.compress_batch(level=2)` on the card, end to end.

    PYTHONPATH=<checkout> python <this file> [--mb 48] [--runs 3]

Compresses the real-file corpus in 64 KB blocks at level 2 with the
`TorchBackend` of the `lz4_tpu_torch` package that Python finds first, so
one command line can time two checkouts of the package side by side: run
this file by its path with `PYTHONPATH` naming the checkout to time (the
one it reports as `package`). Each run is timed on the host clock with the
device synchronised, best of `--runs` after a warm-up. The streams are
round-tripped through the host C decoder. Prints one JSON line: the
card's name and power limit, the package's path, ms, MB/s, ratio, and the
route counters the backend has (`hc_encoded`, and `device_hc_encoded`
where it exists). Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import lz4_tpu_torch
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.realcorpus import real_corpus

BLOCK = 65536


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _best_ms(fn, runs):
    fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=48)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("level2_route: no CUDA device", file=sys.stderr)
        return 2
    data = real_corpus(args.mb << 20)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    be = TorchBackend("cuda")
    comp = be.compress_batch(blocks, level=2)
    if HostBackend().decompress_batch(comp, [BLOCK] * len(blocks)) != blocks:
        raise AssertionError("level 2 streams fail the host C decoder")
    ms = _best_ms(lambda: be.compress_batch(blocks, level=2), args.runs)
    print(json.dumps({
        "probe": "level2_route", "card": _card(),
        "package": lz4_tpu_torch.__file__, "blocks": len(blocks),
        "bytes": len(data), "ms": ms, "MBs": len(data) / 1e6 / ms * 1e3,
        "ratio": len(data) / sum(len(c) for c in comp),
        "counters": {k: getattr(be, k) for k in ("hc_encoded",
                                                 "device_hc_encoded")
                     if hasattr(be, k)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
