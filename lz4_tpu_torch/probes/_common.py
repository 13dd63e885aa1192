"""What the probe kernels' wrappers share (`walk_probe`, `gather_probe`,
`lane_probe`): their inputs' placement, int32 wrapping for the plain
versions, the launch check, the bound of a body on the card, and the loop
that times each body and holds it against its plain version (`Body`,
`measure`, `cli`)."""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from lz4_tpu_torch.block.batch import resolve_device

#: H100 SXM peaks (NVIDIA's data sheet): device memory, float32 outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

_M32 = 0xFFFFFFFF


def as_input(a, device=None, dtype=torch.int32) -> torch.Tensor:
    """A tensor stays where it is; anything else (numpy) goes to
    `device`, the GPU by default (raising where there is none: pass
    device="cpu" for the plain versions)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        t = torch.as_tensor(np.asarray(a)).to(resolve_device(device))
    if t.dtype != dtype:
        raise TypeError(f"expected a {dtype} tensor, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("inputs must be contiguous")
    return t


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {dev}")
    return dev


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding any integer -> the same value wrapped to int32's
    range (still int64): jnp's int32 arithmetic."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _card_times(call, runs: int = 5) -> dict:
    """`ms`: one call after a sync, best of `runs` (the `ms` of every
    kernel in `chip_smoke.py`'s kernels line, the host's launch time
    included); `ms_back_to_back`: the mean of calls queued behind each
    other (20 a run, 3 for calls of 1 ms or more), best of 2."""
    from lz4_tpu_torch.probes._timing import cuda_ms, cuda_ms_back_to_back
    ms = cuda_ms(call, runs=runs)
    return {"ms": ms, "ms_back_to_back": cuda_ms_back_to_back(
        call, reps=20 if ms < 1 else 3, runs=2)}


def bound(nbytes: float, fp32_ops: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the device
    memory's rate and the float32 operations over the peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")


@dataclass(frozen=True)
class Body:
    """One probe body on the card at the tool's sizes. `run` launches its
    kernel once and returns (outs, stats): the outputs, a tuple of
    tensors, and what the kernel reports of itself (SM cycles, steps) or
    None. `plain` computes `outs` on the same inputs with the plain
    version. `report(stats, ms)` gives what the body's stats and time say
    (steps, ns and SM cycles a step) and its `bound_ms` and `bound_by`.
    `library`, where there is one, is a PyTorch call of the same function
    on the same inputs, timed beside it."""
    name: str
    replaces: str
    run: Callable[[], tuple]
    plain: Callable[[], tuple]
    report: Callable[[Any, float], dict]
    count: dict = field(default_factory=dict)
    library: Callable[[], Any] | None = None


def _plain_timed(plain, runs: int):
    """(outs, ms) of the plain version: one call timed on its own; one of
    under 100 ms is timed again warm, best of `runs`."""
    from lz4_tpu_torch.probes._timing import cuda_ms
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    want = plain()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    return want, (cuda_ms(plain, runs) if ms < 100 else ms)


def _max_abs_err(got, want) -> float:
    if len(got) != len(want) or any(g.shape != w.shape
                                    for g, w in zip(got, want)):
        return float("inf")
    return max((float((g.to(torch.float64) - w.to(torch.float64))
                      .abs().max()) if g.numel() else 0.0)
               for g, w in zip(got, want))


def measure(bodies, launched: Callable[[], int], runs: int = 5) -> dict:
    """Each body timed on the card (`ms`, one launch after a sync, best of
    `runs`, and `ms_back_to_back`), the launches that took (`launched()`
    is the wrapper's count) and the output of its last timed launch held
    against the plain version on the same inputs (`same_as_plain`: exact
    equality; `max_abs_err`; `plain_ms`), with `library_ms` where there is
    a library call and the body's report. Keyed by body name."""
    from lz4_tpu_torch.probes._timing import cuda_ms
    res = {}
    for body in bodies:
        last = []

        def call(body=body, last=last):
            last[:] = [body.run()]
        before = launched()
        r = _card_times(call, runs)
        r["launches"] = launched() - before
        outs, stats = last[0]
        want, plain_ms = _plain_timed(body.plain, runs)
        same = len(outs) == len(want) and all(
            g.shape == w.shape and torch.equal(g, w)
            for g, w in zip(outs, want))
        r.update(same_as_plain=same, max_abs_err=_max_abs_err(outs, want),
                 plain_ms=plain_ms, library_ms=(
                     cuda_ms(body.library, runs) if body.library else None),
                 **body.report(stats, r["ms"]), count=body.count,
                 replaces=body.replaces)
        res[body.name] = r
    return res


def cli(probe: str, lib: str, bodies, launched, runs: int, **meta) -> int:
    """A probe's command line: build `lib`, `measure` its bodies and
    print one JSON line with the card's name and power limit. Returns 0
    when every body equals its plain version, 1 when one does not, 2
    without a CUDA device."""
    if not torch.cuda.is_available():
        print(f"{probe}: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch import _build
    from lz4_tpu_torch.probes._timing import card
    _build.build([lib])
    res = measure(bodies(), launched, runs)
    print(json.dumps({"probe": probe, "card": card(), **meta,
                      "bodies": res}), flush=True)
    return 0 if all(r["same_as_plain"] for r in res.values()) else 1
