"""The comparison that decides `correct`.

Each call of the window returns one answer a block. After the window
has closed, a sample of those answers, `checks_per_call` blocks of every
call, is held to the benchmark's own reference. The positions run
through a permutation of the batch drawn from the seed, so that every
position of the batch is checked once in each `batch_blocks /
checks_per_call` calls, and a fault at one position or in a few slots
cannot slip past a window: a compressed stream must decode, by the
strict plain decoder of `reference.py`, to exactly the block's source
bytes; a decompressed block must equal them. The source bytes are the
benchmark's corpus, which the program never saw but as its input.

The sample is decoded by worker processes forked after the window, one
a core but one of those this process may run on, where it holds at
least `POOL_FROM` answers; they only decode bytes on the host and end
before the check returns.

Three numbers are compared, each with the limit 0 (an exact
comparison): `bad_blocks` (sampled answers that fail), `missing_blocks`
(answers a call did not return, counted over every call) and
`raised_calls` (calls that raised).
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np

from benchmark import reference

LIMITS = {"bad_blocks": 0, "missing_blocks": 0, "raised_calls": 0}
#: the smallest sample decoded by a pool of worker processes
POOL_FROM = 64
#: (kind, answer, source) of each sampled answer, read by forked workers
_JOBS: list = []


class Picks:
    """The sampled block positions of each call: call i checks entries
    i * per_call .. (i + 1) * per_call - 1 (wrapping) of a permutation of
    the batch's positions drawn from the seed, so the picks do not
    depend on how many calls a window holds, and every position comes up
    once in each batch_blocks / per_call calls."""

    def __init__(self, seed: int, per_call: int, batch_blocks: int):
        self.per_call = min(per_call, batch_blocks)
        self.batch_blocks = batch_blocks
        rng = np.random.default_rng([int(seed), 1])
        self.order = rng.permutation(batch_blocks).tolist()

    def __call__(self, call: int) -> list[int]:
        first = call * self.per_call
        return sorted(self.order[(first + j) % self.batch_blocks]
                      for j in range(self.per_call))


def block_fault(kind: str, answer, source: bytes) -> str | None:
    """What is wrong with one answer (None if nothing): `kind` is
    "stream" for a compressed stream, "block" for decompressed bytes."""
    if answer is None:
        return "missing"
    if kind == "stream":
        try:
            got = reference.decode_block(answer, len(source))
        except reference.FormatError as e:
            return f"format: {e}"
    else:
        got = bytes(answer)
    if got != source:
        n = min(len(got), len(source))
        a = np.frombuffer(got, np.uint8, n)
        b = np.frombuffer(source, np.uint8, n)
        diff = np.flatnonzero(a != b)
        at = int(diff[0]) if diff.size else n
        return f"differs at byte {at} ({len(got)} vs {len(source)} bytes)"
    return None


def _fault_of(n: int) -> str | None:
    return block_fault(*_JOBS[n])


def verify(kind: str, kept, source_of,
           workers: int | None = None) -> tuple[int, list[str]]:
    """(bad_blocks, notes) over the kept answers: `kept` holds (batch,
    block, answer) triples, `source_of(batch, block)` the source
    bytes. `workers` (by default a core but one, where the sample holds
    `POOL_FROM` answers or more) decode in forked processes."""
    global _JOBS
    _JOBS = [(kind, answer, source_of(k, j)) for k, j, answer in kept]
    if workers is None:
        workers = len(os.sched_getaffinity(0)) - 1 \
            if len(_JOBS) >= POOL_FROM else 1
    try:
        if workers > 1:
            chunk = max(1, len(_JOBS) // (workers * 8))
            with multiprocessing.get_context("fork").Pool(workers) as pool:
                faults = pool.map(_fault_of, range(len(_JOBS)), chunk)
                pool.close()
                pool.join()
        else:
            faults = [_fault_of(n) for n in range(len(_JOBS))]
    finally:
        _JOBS = []
    bad, notes = 0, []
    for (k, j, _), fault in zip(kept, faults):
        if fault is not None:
            bad += 1
            if len(notes) < 5:
                notes.append(f"batch {k} block {j}: {fault}")
    return bad, notes


def numbers(bad: int, missing: int, raised: int) -> dict:
    """The compared numbers, each beside its limit."""
    vals = {"bad_blocks": bad, "missing_blocks": missing,
            "raised_calls": raised}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in vals.items()}


def passed(nums: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in nums.values())
