"""P1 on Hopper: lane, flat and row gathers over a 64 K-word block, the
fused 8-round chase and the serial hop loop (`csrc/probe_gather.cu`).

    python -m lz4_tpu_torch.probes.gather_probe [--runs 5]

Ports `tools/pallas_probe.py` (`k_lane`, `k_flat`, `k_row`, `k_chase`,
`k_hops`) on its data: B = 32 blocks of int32 (R, C) = (512, 128), seed
3, drawn in the tool's order. The bodies (`gather`'s):

- `lane`: out[r, c] = x[r, idx[r, c] mod C];
- `row`: out[r, c] = x[idx[r, c] mod R, c];
- `flat`: out = x.flat[idx mod N], N = R * C;
- `chase`: 8 rounds of ptr = where(ptr >= 0, ptr[clip(ptr, 0, N - 1)],
  ptr) over the whole block (one CTA a block, global memory);
- `hops`: 8192 dependent steps a block of out[k] = cur; cur = nm[min(cur
  + ml[cur], N - 1)], one thread a block (global memory), out int32[B,
  8192 / C, C].

lane, row and flat stream: a thread takes 4 consecutive words (16-byte
loads of the indices, 16-byte stores; 4-byte ones where a view's start is
not 16-byte aligned). lane stages a warp's 128 words of x in the warp's
own shared memory where C <= 128 (whole rows, no CTA barrier); row copies
a strip of 32 columns over all R rows into a CTA's shared memory while it
loads the strip's indices, where the strip fits in 64 KB; flat, longer
lane rows and taller row strips read their 4 source words from global
memory through L1/L2, the loads issued together. They launch through the
library's CPython entry (`csrc/pyentry.h`): one C call checks the
inputs, allocates the output with `torch.empty_like` and launches; where
a check fails or the tensors sit off the current device it returns None
and `gather` runs its Python checks (which raise) or enters the device.
chase and hops launch through ctypes with their scratch and stats.

Indices wrap mod the gathered extent, as the TPU's gathers do (R and C
powers of two). Each body runs at the tool's sizes, and the output of its
last timed launch is held against its plain version on the same inputs
(`probes/_common.measure`; the plain hop loop takes a few torch ops a
step). It reports `ms` (`probes/_timing.cuda_ms`, one launch after a
sync, which for these short kernels holds the host's launch time;
`ms_back_to_back` beside it), for the chains `ns_per_step` and
`cycles_per_step` (clock64 of a block's thread), and for lane, row and
flat the host's and the card's time a call (`host_us`, `device_us`), the
time behind an L2 flush (`ms_l2_flushed`: their 25.2 MB fit the 50 MB
L2) and one `torch.gather` of the same function on the same inputs (the
TPU tool's `xla_flat_gather`) timed on the same methods (`library_ms`,
`library_ms_back_to_back`, `library_host_us`, `library_device_us`,
`library_ms_l2_flushed`).
Prints one JSON line with the card's name and power limit. Needs one CUDA
GPU and nvcc.

On CPU tensors (or `device="cpu"`) `gather` runs the plain versions:
`torch.gather` on the wrapped indices for lane, row and flat, the rounds
as gathers for chase, and a loop over the steps for hops.
"""
from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.probes import _common as cm

R, C = 512, 128
B = 32
STEPS = 8192
ROUNDS = 8
LIB = "probe_gather"
SOURCE = "lz4_tpu_torch/csrc/probe_gather.cu"

VARIANTS = {"lane": 0, "flat": 1, "row": 2, "chase": 3, "hops": 4}
#: the bodies launched through the library's Python entry (`csrc/pyentry.h`)
STREAMS = {"lane": 0, "flat": 1, "row": 2}
REPLACES = {"lane": "tools/pallas_probe.py:78",
            "flat": "tools/pallas_probe.py:89",
            "row": "tools/pallas_probe.py:103",
            "chase": "tools/pallas_probe.py:115",
            "hops": "tools/pallas_probe.py:134"}

#: the library's Python entry (`csrc/pyentry.h`), once loaded
_entry = None


def _load_entry():
    global _entry
    _entry = _build.module(LIB).gather
    return _entry


#: kernel launches made by `gather` (and nowhere else)
launches = 0


def inputs(b: int = B, r: int = R, c: int = C, seed: int = 3) -> dict:
    """The tool's arrays, drawn in its order: x, col_idx, flat_idx,
    row_idx, chain, nm, ml (int32[b, r, c] each)."""
    n = r * c
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**31, (b, r, c), dtype=np.int32)
    col = rng.integers(0, c, (b, r, c), dtype=np.int32)
    flat = rng.integers(0, n, (b, r, c), dtype=np.int32)
    row = rng.integers(0, r, (b, r, c), dtype=np.int32)
    chain = rng.integers(-n, n, (b, r, c)).astype(np.int32)
    nm = rng.integers(0, n - 1, (b, r, c), dtype=np.int32)
    ml = rng.integers(4, 12, (b, r, c), dtype=np.int32)
    return {"x": x, "lane": col, "flat": flat, "row": row, "chase": chain,
            "nm": nm, "ml": ml}


def _pow2(v: int) -> bool:
    return v > 0 and not v & (v - 1)


def gather(body: str, a, b=None, *, steps: int | None = None, device=None):
    """One probe body (see the module docstring) on int32[B, R, C]
    inputs: lane, flat, row take (x, idx); chase (p) with `steps` rounds
    (8); hops (nm, ml) with `steps` steps (8192, a multiple of C).
    Returns (out, stats): out int32[B, R, C] (hops: int32[B, steps / C,
    C]); stats int64[B, 2] (SM cycles, steps of each block's chain) for
    chase and hops on the card, else None."""
    global launches
    code = STREAMS.get(body)
    if (code is not None and type(a) is torch.Tensor
            and type(b) is torch.Tensor and a.is_cuda):
        # lane, flat, row: the checks, the output and the launch in one C
        # call; None where a check fails or the device is not the current
        # one
        out = (_entry or _load_entry())(a, b, code)
        if out is not None:
            launches += 1
            return out, None
    if body not in VARIANTS:
        raise ValueError(f"body must be one of {sorted(VARIANTS)}")
    a = cm.as_input(a, device)
    ins = [a] if body == "chase" else [a, cm.as_input(b, device)]
    dev = cm.same_device(*ins)
    if a.dim() != 3 or a.shape[0] == 0:
        raise ValueError(f"inputs must be int32[B, R, C], got "
                         f"{tuple(a.shape)}")
    nb, r, c = a.shape
    if not (_pow2(r) and _pow2(c) and r <= 8192 and c <= 8192):
        raise ValueError("R and C must be powers of two up to 8192")
    if any(t.shape != a.shape for t in ins):
        raise ValueError("inputs must have one shape")
    if steps is None:
        steps = {"chase": ROUNDS, "hops": STEPS}.get(body, 0)
    if body == "hops" and (steps <= 0 or steps % c):
        raise ValueError(f"hops takes a positive multiple of C={c} steps")
    if body == "chase" and steps < 0:
        raise ValueError("chase takes rounds >= 0")
    if dev.type == "cpu":
        return gather_plain(body, *ins, steps=steps), None
    if code is not None:
        with torch.cuda.device(dev):
            out = (_entry or _load_entry())(a, ins[-1], code)
        if out is None:
            raise RuntimeError(f"probe_gather {body}: the kernel refused "
                               f"{dev}")
        launches += 1
        return out, None
    if body == "hops":
        out = torch.empty((nb, steps // c, c), dtype=torch.int32, device=dev)
    else:
        out = torch.empty_like(a)
    scratch = torch.empty_like(a) if body == "chase" else None
    stats = torch.empty((nb, 2), dtype=torch.int64, device=dev)
    rc = cm.launch(_build.load(LIB), dev, a.data_ptr(), ins[-1].data_ptr(),
                   out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   stats.data_ptr(), nb, r, c, VARIANTS[body], steps)
    cm.check_rc(rc, f"probe_gather {body}")
    launches += 1
    return out, stats


def gather_plain(body: str, a: torch.Tensor, b: torch.Tensor | None = None,
                 *, steps: int) -> torch.Tensor:
    """Plain version of `gather`'s out, on the tensors' own device."""
    nb, r, c = a.shape
    n = r * c
    if body == "lane":
        return torch.gather(a, 2, b.to(torch.int64).remainder(c))
    if body == "row":
        return torch.gather(a, 1, b.to(torch.int64).remainder(r))
    if body == "flat":
        idx = b.reshape(nb, n).to(torch.int64).remainder(n)
        return a.reshape(nb, n).gather(1, idx).reshape(nb, r, c)
    if body == "chase":
        ptr = a.reshape(nb, n)
        for _ in range(steps):
            nxt = ptr.gather(1, ptr.clamp(0, n - 1).to(torch.int64))
            ptr = torch.where(ptr >= 0, nxt, ptr)
        return ptr.reshape(nb, r, c)
    nm = a.reshape(nb, n).to(torch.int64)
    ml = b.reshape(nb, n).to(torch.int64)
    cur = torch.zeros((nb, 1), dtype=torch.int64, device=a.device)
    out = []
    for _ in range(steps):
        out.append(cur)
        lin = torch.minimum(cur + ml.gather(1, cur.remainder(n)),
                            torch.full_like(cur, n - 1))
        cur = nm.gather(1, lin.remainder(n))
    return torch.cat(out, 1).to(torch.int32).reshape(nb, steps // c, c)


# ---------------------------------------------------------------- on the card

def _args(body: str, d: dict):
    if body == "chase":
        return (d["chase"],)
    if body == "hops":
        return d["nm"], d["ml"]
    return d["x"], d[body]


def _chain_report(body: str):
    words = B * R * C

    def report(stats, ms: float) -> dict:
        if stats is None:
            # lane, row, flat: the index and the source in, out
            b_ms, by = cm.bound(12 * words)
            return {"bound_ms": b_ms, "bound_by": by}
        st = stats.cpu().to(torch.float64)
        steps = int(st[:, 1].max())
        # chase: the block in and out; hops: the words its chains visit
        # (two reads and one write a step)
        b_ms, by = cm.bound(8 * words if body == "chase"
                            else 12 * B * STEPS)
        return {"steps": steps, "ns_per_step": ms * 1e6 / max(steps, 1),
                "cycles_per_step": float((st[:, 0] / st[:, 1].clamp(
                    min=1)).mean()), "bound_ms": b_ms, "bound_by": by}
    return report


def bodies() -> list[cm.Body]:
    """Every body at the tool's sizes on the card's copy of `inputs()`,
    with `torch.gather` of the same function for lane, row and flat."""
    d = {k: torch.from_numpy(v).cuda() for k, v in inputs().items()}
    lib = {"lane": (d["x"], 2, d["lane"].to(torch.int64)),
           "row": (d["x"], 1, d["row"].to(torch.int64)),
           "flat": (d["x"].reshape(B, R * C), 1,
                    d["flat"].reshape(B, R * C).to(torch.int64))}
    out = []
    for body in VARIANTS:
        args = _args(body, d)

        def run(body=body, args=args):
            got, stats = gather(body, *args)
            return (got,), stats

        def plain(body=body, args=args):
            return (gather_plain(body, *args, steps=STEPS if body == "hops"
                                 else ROUNDS),)
        out.append(cm.Body(
            f"P1 k_{body}", REPLACES[body], run, plain, _chain_report(body),
            {"steps": STEPS} if body == "hops" else {"B": B, "R": R, "C": C},
            partial(torch.gather, *lib[body]) if body in lib else None,
            host=body in lib, flushed=body in lib))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    return cm.cli("gather_probe", LIB, bodies, lambda: launches, args.runs,
                  shape=[B, R, C])


if __name__ == "__main__":
    sys.exit(main())
