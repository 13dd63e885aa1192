"""What the probe kernels' wrappers share (`walk_probe`, `gather_probe`,
`lane_probe`): their inputs' placement, int32 wrapping for the plain
versions, the launch check, the bounds of a body on the card (its bytes
once, `bound`; its longest dependent chain, `Floor` and `chain_fields`),
and the loop that times each body and holds it against its plain version
(`Body`, `measure`, `cli`)."""
from __future__ import annotations

import json
import sys
from dataclasses import asdict, dataclass, field
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


def launch(fn, dev: torch.device, *args) -> int:
    """fn(*args, stream): a C entry point on `dev`'s current stream (its
    raw handle), inside a device guard only where `dev` is not the
    current device. Returns fn's result (a cudaError_t)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _card_times(call, runs: int = 5, host: bool = False,
                flushed: bool = False, prefix: str = "") -> dict:
    """`ms`: one call after a sync, best of `runs` (the `ms` of every
    kernel in `chip_smoke.py`'s kernels line, the host's launch time
    included); `ms_back_to_back`: the mean of calls queued behind each
    other (20 a run, 3 for calls of 1 ms or more), best of `runs`; with
    `host`, `host_us` and `device_us`: the host's microseconds a call and
    the card's in its kernels (`_timing.host_us`, `_timing.device_us`);
    with `flushed`, `ms_l2_flushed`: one call behind an L2 flush, best of
    `runs`. Each key is prefixed with `prefix`."""
    from lz4_tpu_torch.probes._timing import (cuda_ms, cuda_ms_back_to_back,
                                              cuda_ms_flushed, device_us,
                                              host_us)
    ms = cuda_ms(call, runs=runs)
    r = {"ms": ms, "ms_back_to_back": cuda_ms_back_to_back(
        call, reps=20 if ms < 1 else 3, runs=runs)}
    if host:
        r["host_us"] = host_us(call)
        r["device_us"] = device_us(call)
    if flushed:
        r["ms_l2_flushed"] = cuda_ms_flushed(call, runs=runs)
    return {prefix + k: v for k, v in r.items()}


def bound(nbytes: float, fp32_ops: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the device
    memory's rate and the float32 operations over the peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")


#: the instruction classes a chain bound prices, in the order of the
#: latency build's stats (`csrc/probe_walk.cu`, -DLZ4T_PROBE_LATENCY):
#: LDS; a global load that hits L1; one that misses L1 and hits L2;
#: IADD3, LOP3 and the other integer ALU ops (ISETP, SEL, IMNMX, LEA,
#: SHF); IMAD; FMUL and FADD; SHFL
CLASSES = ("lds", "ldg_l1", "ldg_l2", "alu", "imad", "fp32", "shfl")


@dataclass(frozen=True)
class Floor:
    """What a chain bound is priced with: the SM cycles of one instruction
    of each class on a dependent chain (`cycles`, class -> cycles, from
    the latency build: `walk_probe.latencies`) and the SM clock in MHz
    (`sm_mhz`, nvidia-smi's `clocks.sm` read beside the phase); beside
    them, what else the measurement read (`floor()`: the latency launch's
    own clock, nvidia-smi's `clocks.max.sm`, and whether the card was
    still busy when nvidia-smi's read returned)."""
    cycles: dict
    sm_mhz: float
    kernel_mhz: float | None = None
    sm_max_mhz: float | None = None
    busy_at_read: bool | None = None


def chain_fields(per_step: dict, steps: float, ms: float,
                 floor: Floor | None, cycles: float) -> dict:
    """A body's chain bound: its longest dependent chain is `steps` steps,
    each `per_step[k]` instructions of class k on the critical path (read
    from the kernel's SASS; branches cost nothing, so it is a least time).
    `chain_bound_cycles` is that chain priced at `floor.cycles`,
    `chain_bound_ms` the same at `floor.sm_mhz`, `chain_share`
    chain_bound_ms / ms. Beside them, in the same unit, the SM cycles the
    kernel's clock64 measured on that chain (`cycles`, as
    `longest_chain_cycles`) and `chain_cycles_share`, chain_bound_cycles
    over them: the share without the host's launch, above 1 where a count
    or a price is wrong. Empty without a floor."""
    if floor is None:
        return {}
    cycles = float(cycles)
    step = sum(n * floor.cycles[k] for k, n in per_step.items())
    bound = step * steps
    b_ms = bound / (floor.sm_mhz * 1e3)
    return {"chain": dict(per_step), "chain_cycles_per_step": step,
            "chain_bound_cycles": bound, "chain_bound_ms": b_ms,
            "chain_share": b_ms / ms if ms > 0 else float("inf"),
            "longest_chain_cycles": cycles,
            "chain_cycles_share": bound / cycles if cycles > 0
            else float("inf")}


@dataclass(frozen=True)
class Body:
    """One probe body on the card at the tool's sizes. `run` launches its
    kernel once and returns (outs, stats): the outputs, a tuple of
    tensors, and what the kernel reports of itself (SM cycles, steps) or
    None. `plain` computes `outs` on the same inputs with the plain
    version. `report(stats, ms, floor)` gives what the body's stats and
    time say (steps, ns and SM cycles a step), its `bound_ms` and
    `bound_by` and, for a chain body given a `Floor`, its `chain_fields`.
    `library`, where there is one, is a PyTorch call of the same function
    on the same inputs, timed beside it on the same methods. `host` adds
    the host's and the card's time a call (`host_us`, `device_us`),
    `flushed` the time behind an L2 flush (`ms_l2_flushed`), to the body
    and its library call."""
    name: str
    replaces: str
    run: Callable[[], tuple]
    plain: Callable[[], tuple]
    report: Callable[[Any, float], dict]
    count: dict = field(default_factory=dict)
    library: Callable[[], Any] | None = None
    host: bool = False
    flushed: bool = False


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


def _best(a: dict, b: dict) -> dict:
    return {k: min(v, b[k]) for k, v in a.items()}


def floor() -> Floor:
    """The chain bounds' prices on the current card: the latency build's
    cycles an instruction, at the SM clock nvidia-smi reads while the card
    is busy. Raises when nvidia-smi's read outlasted the spin twice (an
    idle card's clock would price every chain several times too high)."""
    from lz4_tpu_torch.probes import walk_probe
    from lz4_tpu_torch.probes._timing import sm_clock
    for busy_s in (2.0, 8.0):
        clock = sm_clock(busy_s)
        if clock["busy_at_read"]:
            return Floor(**walk_probe.latencies(), **clock)
    raise RuntimeError(f"nvidia-smi read the SM clock after a spin of "
                       f"{busy_s:g} s had ended: {clock}")


def measure(bodies, launched: Callable[[], int], runs: int = 5,
            floor: Floor | None = None) -> dict:
    """Each body timed on the card (`_card_times`: `ms`, one launch after a
    sync, best of `runs`, `ms_back_to_back`, and `host_us`, `device_us`
    and `ms_l2_flushed` where the body asks), the launches that took
    (`launched()` is the wrapper's count) and the output of its last timed
    launch held against the plain version on the same inputs
    (`same_as_plain`: exact equality; `max_abs_err`; `plain_ms`), with
    the library call, where there is one, timed on the same methods
    through the same harness (`library_ms`, `library_ms_back_to_back`,
    ...; `library_ms` None without one) and the body's report. A body
    with a library call is timed in turns with it, kernel, library,
    kernel, library, and each keeps the best of its two passes. A chain
    body's report prices its chain at `floor`. Keyed by body name."""
    res = {}
    for body in bodies:
        last, lib_last = [], []

        def call(body=body, last=last):
            last[:] = [body.run()]

        def lib_call(body=body, last=lib_last):
            last[:] = [body.library()]
        before = launched()
        r = _card_times(call, runs, body.host, body.flushed)
        lib = {"library_ms": None}
        if body.library:
            # kernel, library, kernel, library: the best of each
            lib = _card_times(lib_call, runs, body.host, body.flushed,
                              "library_")
            r = _best(r, _card_times(call, runs, body.host, body.flushed))
            lib = _best(lib, _card_times(lib_call, runs, body.host,
                                         body.flushed, "library_"))
        r["launches"] = launched() - before
        outs, stats = last[0]
        want, plain_ms = _plain_timed(body.plain, runs)
        same = len(outs) == len(want) and all(
            g.shape == w.shape and torch.equal(g, w)
            for g, w in zip(outs, want))
        r.update(same_as_plain=same, max_abs_err=_max_abs_err(outs, want),
                 plain_ms=plain_ms, **lib,
                 **body.report(stats, r["ms"], floor),
                 count=body.count, replaces=body.replaces)
        res[body.name] = r
    return res


def cli(probe: str, lib: str, bodies, launched, runs: int, **meta) -> int:
    """A probe's command line: build `lib`, price the chains (`floor`),
    `measure` its bodies and print one JSON line with the card's name and
    power limit and the floor. Returns 0 when every body equals its plain
    version, 1 when one does not, 2 without a CUDA device."""
    if not torch.cuda.is_available():
        print(f"{probe}: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch import _build
    from lz4_tpu_torch.probes._timing import card
    _build.build([lib])
    fl = floor()
    res = measure(bodies(), launched, runs, fl)
    print(json.dumps({"probe": probe, "card": card(), **meta,
                      "floor": asdict(fl), "bodies": res}), flush=True)
    return 0 if all(r["same_as_plain"] for r in res.values()) else 1
