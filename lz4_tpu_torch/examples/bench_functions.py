"""Per-function micro-benchmark, the bench_functions.c analog: the block
entry points (fast and HC compress, decompress) on the host C tier, and
the one-shot frame surfaces on the default backend (the GPU unless
`backend` names another). Host-clock MB/s, best of 3; the per-kernel
figures come from `python -m lz4_tpu_torch.bench`.

    python -m lz4_tpu_torch.examples.bench_functions
"""
import time

import lz4_tpu_torch
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.utils.datagen import mixed_corpus

N = 4 * 1024 * 1024


def timed(name, fn, nbytes, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{name:<28} {nbytes / 1e6 / best:8.1f} MB/s")
    return r


def main(backend=None):
    data = mixed_corpus(N, seed=9)
    blocks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    be = HostBackend()
    comp = timed("block compress (fast)",
                 lambda: be.compress_batch(blocks), N)
    timed("block compress (HC -9)",
          lambda: be.compress_batch(blocks, level=9), N)
    timed("block decompress",
          lambda: be.decompress_batch(comp, [len(b) for b in blocks]), N)
    blob = timed("frame compress",
                 lambda: lz4_tpu_torch.compress(data, backend=backend), N)
    back = timed("frame decompress",
                 lambda: lz4_tpu_torch.decompress(blob, backend=backend), N)
    assert back == data


if __name__ == "__main__":
    main()
