"""Device timers shared by `chip_smoke.py` and the probes (CUDA events).

- `cuda_ms`: one call after a sync, best of `runs` (the `ms` of every
  kernel in `chip_smoke.py`'s `kernels` line); for a kernel of a few
  tens of microseconds it also holds the host's time to launch it;
- `cuda_ms_back_to_back`: the mean of `reps` calls queued behind each
  other, best of `runs` (the host's launch time hidden, the L2 warm);
- `cuda_ms_flushed`: one call queued behind a write of a 128 MB buffer,
  which evicts the 50 MB L2, and a spin on the card of some 100 us, which
  lets the host queue the call before the card reaches it.

Each warms up with one call first. Needs a CUDA device. `card()` is the
card's name and power limit as nvidia-smi gives them, for every line a
probe prints.
"""
from __future__ import annotations

import subprocess

import torch

FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 200_000        # some 100 us at the H100's clock


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def cuda_ms(fn, runs=5):
    """Best of `runs` timings of one fn() after a sync, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(runs):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def cuda_ms_back_to_back(fn, reps=20, runs=5):
    """Best of `runs` means of `reps` calls of fn() back to back, after a
    warm-up."""
    fn()
    best = float("inf")
    for _ in range(runs):
        a, b = _events()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def cuda_ms_flushed(fn, runs=10, flush=None):
    """Best of `runs` timings of one fn() with the L2 flushed before it,
    after a warm-up. `flush` is a device buffer of at least 128 MB to
    write (one is made when it is None)."""
    if flush is None:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    best = float("inf")
    for i in range(runs):
        flush.fill_(i & 0xFF)
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best
