"""Device timers shared by `chip_smoke.py` and the probes (CUDA events).

- `cuda_ms`: one call after a sync, best of `runs` (the `ms` of every
  kernel in `chip_smoke.py`'s `kernels` line); for a kernel of a few
  tens of microseconds it also holds the host's time to launch it;
- `cuda_ms_back_to_back`: the mean of `reps` calls queued behind each
  other, best of `runs` (the host's launch time hidden, the L2 warm);
- `cuda_ms_flushed`: one call queued behind a write of a 128 MB buffer,
  which evicts the 50 MB L2, and a spin on the card of some 100 us, which
  lets the host queue the call before the card reaches it;
- `host_us`: the host's microseconds a call, over calls queued without
  a sync (what `cuda_ms` holds of the host's launch path);
- `device_us`: the card's microseconds a call in the kernels it
  launches (`torch.profiler`), the other part of `cuda_ms`;
- `timed_runs`: `cuda_ms`'s device time beside the host's wall time of
  the same calls, run for a time budget (`probes/fullbench.py`).

Each warms up with one call first. Needs a CUDA device (`timed_runs`
also runs on the CPU, where it gives the host time only). `card()` is the
card's name and power limit as nvidia-smi gives them, for every line a
probe prints.
"""
from __future__ import annotations

import subprocess
import time

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


def host_us(fn, calls=200, runs=3):
    """Best of `runs` host times a call, in microseconds, after a warm-up:
    `calls` calls of fn() queued without a sync, the clock stopped before
    the sync that follows them."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        best = min(best, dt / calls * 1e6)
    return best


def device_us(fn, calls=20):
    """Microseconds a call that the card spends in the kernels fn()
    launches: the self device time of every event torch.profiler records
    (CUDA activity) over `calls` calls, after a warm-up, over `calls`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages())
    return total / calls


def timed_runs(fn, seconds, min_runs=3, max_runs=40, cuda=True):
    """(device ms, host ms, runs): fn() called after a sync until
    `seconds` of host time have passed and at least `min_runs` calls
    (at most `max_runs`), after a warm-up; the best device time between
    CUDA events around each call (None where `cuda` is false) and the
    best host time from before the call to the end of the sync after it.
    """
    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    best_dev = best_host = float("inf")
    elapsed, runs = 0.0, 0
    while (elapsed < seconds or runs < min_runs) and runs < max_runs:
        sync()
        if cuda:
            a, b = _events()
            a.record()
        t0 = time.perf_counter()
        fn()
        if cuda:
            b.record()
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        if cuda:
            best_dev = min(best_dev, a.elapsed_time(b))
        best_host = min(best_host, dt)
        elapsed += dt / 1e3
        runs += 1
    return (best_dev if cuda else None), best_host, runs
