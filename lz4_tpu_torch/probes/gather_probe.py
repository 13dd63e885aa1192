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
  ptr) over the whole block. Where the block fits a cluster's shared
  memory (`chase_route`: 32 <= N <= 131,072) a cluster of 8 CTAs takes a
  block, an eighth in each CTA's shared memory, every round gathered
  through the cluster's distributed shared memory; other N take one CTA
  a block in global memory (L2). The probe times both: `P1 k_chase` at
  the tool's shape, `P1 k_chase global` at int32[32, 2048, 128];
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
chase and hops launch through ctypes with their scratch and stats (the
cluster body leaves chase's scratch unused); a cluster launch the runtime
refuses raises.

Indices wrap mod the gathered extent, as the TPU's gathers do (R and C
powers of two). Each body runs at the tool's sizes, and the output of its
last timed launch is held against its plain version on the same inputs
(`probes/_common.measure`; the plain hop loop takes a few torch ops a
step). It reports `ms` (`probes/_timing.cuda_ms`, one launch after a
sync, which for these short kernels holds the host's launch time;
`ms_back_to_back` beside it), for chase its route, cluster size,
`cudaOccupancyMaxActiveClusters` (`chase_plan`) and throughput bound
over the card's SMs (`chase_throughput`), for the chains `ns_per_step`,
`cycles_per_step` (clock64 of a block's thread; chase's, the most of
its cluster's CTAs) and the chain bound (`_common.chain_fields`; a hop's
load is priced as an L2 hit where it is the launch's first touch of its
128-byte line, which L1 cannot hold yet, and as an L1 hit elsewhere;
chase's as `_chase_chain` says), and for lane, row and
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
import ctypes
import sys
from functools import partial

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.probes import _common as cm

R, C = 512, 128
B = 32
#: rows of the block that chase's global-memory body takes in the probe
#: (int32[B, 2048, C]: 262,144 words, past the cluster's reach)
GLOBAL_R = 2048
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

#: chase's cluster body (`csrc/probe_gather.cu`, `chase_cluster`): the
#: CTAs of a cluster (the portable size) and the most words a CTA holds of
#: its block (twice, as cur and dst: 128 KB of shared memory)
CHASE_CLUSTER = 8
CHASE_CTA_WORDS = 16384

#: instructions a step on the longest chain besides its loads, by class
#: (`_common.CLASSES`), read from the SASS (`cuobjdump -sass` of the built
#: library; stores, branches and barriers priced at 0): chase's round on
#: the cluster body from the word's LDS.128 to its gather (ISETP on v >=
#: 0, whose branch the gather waits on, VIMNMX.U32, LOP3, IMAD.WIDE.U32,
#: PRMT; the gather, LD.E of the cluster's shared window or LDS of the
#: CTA's own, priced as LDS; `_chase_chain`), on the global-memory body
#: (`chase_global`: ISETP, VIMNMX, IADD3, LEA, LEA.HI.X between its two
#: loads, both from L2), and hops' step (LOP3, IADD3, LEA, LEA.HI.X to
#: the first load; IADD3, LEA.HI.X.SX32, ISETP.EX, SEL, LOP3, IADD3, LEA,
#: LEA.HI.X to the second)
CHAINS = {"chase": {"lds": 2, "alu": 4, "imad": 1},
          "chase_global": {"alu": 5}, "hops": {"alu": 12}}
#: the least instructions a word of chase's function, whatever the body:
#: the coalesced load, its predicate (ptr >= 0), the gather's address (one
#: LEA from the word and the block's base), the predicated gather and the
#: store. The upper clamp, the loop's count, the coalesced addresses and
#: a round's barrier are left out (unrolling and immediate offsets can
#: spread them thin), so no body can issue less
CHASE_WORD_INSTRUCTIONS = 5
#: a SM's rates (Hopper): 4 warp schedulers, each issuing one warp
#: instruction a clock; the L1 / shared-memory data path of 32 banks of 4
#: bytes a clock, which every load and store of a CTA passes
WARP_INSTRUCTIONS_PER_CYCLE = 4
L1_BYTES_PER_CYCLE = 128

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


def chase_route(n: int) -> int:
    """The cluster size chase launches for a block of n words (a power of
    two): `CHASE_CLUSTER` where each of its CTAs holds 4 to
    `CHASE_CTA_WORDS` words, else 0, the global-memory body. The C
    launcher's `chase_cluster` is the same cut; on the card `chase_plan`
    asks the library, and the reports use its answer."""
    ok = 4 * CHASE_CLUSTER <= n <= CHASE_CLUSTER * CHASE_CTA_WORDS
    return CHASE_CLUSTER if ok else 0


def chase_plan(n: int) -> dict:
    """What the built chase kernel launches for a block of n words, asked
    of its library: `chase_route` ("cluster" or "global"), `cluster` (CTAs
    a block; 0 on the global-memory body) and `max_active_clusters`
    (`cudaOccupancyMaxActiveClusters` of the cluster body at that size and
    shared memory on the current card; 0 on the global-memory body)."""
    _build.build([LIB])
    fn = ctypes.CDLL(_build.library_path(LIB)).lz4t_probe_chase_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k, active = ctypes.c_int(), ctypes.c_int()
    cm.check_rc(fn(n, ctypes.byref(k), ctypes.byref(active)),
                "probe_gather chase plan")
    return {"chase_route": "cluster" if k.value else "global",
            "cluster": k.value, "max_active_clusters": active.value}


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
    if body == "chase" and a.data_ptr() % 16:
        # the cluster body copies its words with 16-byte bulk copies
        a = ins[0] = a.clone()
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


def hop_first_touches(ml: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """int64[B]: the 128-byte lines of ml and of nm that each block's hop
    chain loads for the first time in the launch, from the cursors it
    wrote (`out`, the cursor before each step): L1 starts the launch
    empty, so no load of those can hit it."""
    nb = ml.shape[0]
    n = ml[0].numel()
    cur = out.reshape(nb, -1).to(torch.int64).cpu()
    step = ml.reshape(nb, n).to(torch.int64).cpu().gather(1, cur & (n - 1))
    lin = torch.clamp(cur + step, max=n - 1) & (n - 1)
    at = cur & (n - 1)
    return torch.tensor([len(torch.unique(at[b] >> 5))
                         + len(torch.unique(lin[b] >> 5))
                         for b in range(nb)])


def chase_l1_bytes(p: torch.Tensor, rounds: int,
                   granule: int = 32) -> torch.Tensor:
    """int64[B, rounds]: the bytes each of chase's rounds moves through a
    block's L1 / shared-memory data path on these inputs. A warp takes 32
    consecutive words at a time: a 128-byte load of them, `granule` bytes
    for each distinct `granule`-byte piece its gathers read (only lanes
    whose word is >= 0 gather: the function reads nothing for the others)
    and a 128-byte store. The piece is an L1 sector (32, the global-memory
    body) or a shared-memory bank's word (4)."""
    nb = p.shape[0]
    n = p[0].numel()
    shift = (granule // 4).bit_length() - 1
    ptr = p.reshape(nb, n).to(torch.int64)
    out = []
    for _ in range(rounds):
        act = ptr >= 0
        c = ptr.clamp(0, n - 1)
        sec = torch.where(act, c >> shift, -1).reshape(nb, -1, 32)
        sec = sec.sort(-1).values
        new = (sec[..., 1:] != sec[..., :-1]) & (sec[..., 1:] >= 0)
        sectors = new.sum((1, 2)) + (sec[..., 0] >= 0).sum(1)
        out.append(n // 32 * 256 + granule * sectors)
        ptr = torch.where(act, ptr.gather(1, c), ptr)
    return torch.stack(out, 1).cpu()


def chase_throughput(p: torch.Tensor, rounds: int,
                     granule: int = 32) -> torch.Tensor:
    """float64[B]: the least SM cycles of each block's rounds by
    throughput on one SM. Each round (all of a round's words are read
    before the next round's) takes at least the larger of its least warp
    instructions (`CHASE_WORD_INSTRUCTIONS` a word, 32 words a warp
    instruction) over the 4 a clock the SM's schedulers take and its
    bytes (`chase_l1_bytes` at `granule`) over the L1 / shared-memory data
    path's 128 a clock."""
    n = p[0].numel()
    instr = n / 32 * CHASE_WORD_INSTRUCTIONS / WARP_INSTRUCTIONS_PER_CYCLE
    l1 = chase_l1_bytes(p, rounds, granule).to(
        torch.float64) / L1_BYTES_PER_CYCLE
    return l1.clamp(min=instr).sum(1)


def chase_card_bound(p: torch.Tensor, rounds: int, sms: int) -> float:
    """The least SM cycles the card could take for chase on `p`: every
    block's rounds' least cycles on one SM (`chase_throughput`), summed
    and spread over the card's `sms` SMs. A gather is priced at 4 bytes a
    distinct word a warp reads, a shared-memory bank's width, which no
    body beats in L1 (a 32-byte sector) or in shared memory; a remote
    read of distributed shared memory is priced as a local one, though
    what it costs its SMs is not measured."""
    return float(chase_throughput(p, rounds, 4).sum()) / sms


def _throughput_fields(p, rounds: int, stats, ms: float, floor,
                       sms: int) -> dict:
    """chase's throughput bound beside its chain bound: the card's least
    cycles (`chase_card_bound` over `sms` SMs: `throughput_bound_cycles`),
    in ms at the floor's clock and as a share of `ms`, and
    `throughput_cycles_share`, that bound over the cycles of the slowest
    block's clock64; beside them the one-SM least of that block with
    gathers priced by L1 sectors (`throughput_bound_cycles_one_sm`,
    `chase_throughput`)."""
    cycles = stats[:, 0].cpu().to(torch.float64)
    at = int(cycles.argmax())
    card = chase_card_bound(p, rounds, sms)
    b_ms = card / (floor.sm_mhz * 1e3)
    return {"sms": sms, "throughput_bound_cycles": card,
            "throughput_bound_cycles_one_sm": float(
                chase_throughput(p, rounds)[at]),
            "throughput_bound_ms": b_ms,
            "throughput_share": b_ms / ms if ms > 0 else float("inf"),
            "throughput_cycles_share": card / float(cycles[at])
            if cycles[at] > 0 else float("inf")}


def _chase_report(p, plan: dict, sms: int):
    """chase's report: its route (`plan`, from `chase_plan`), its chain
    report on that route (`_chain_report`) and, given a floor, its
    throughput bound on its input `p` over `sms` SMs
    (`_throughput_fields`)."""
    chain = _chain_report("chase", n=p[0].numel(), cluster=plan["cluster"])

    def report(stats, ms: float, floor=None) -> dict:
        r = {**plan, **chain(stats, ms, floor)}
        if floor is not None:
            r.update(_throughput_fields(p, int(stats[:, 1].max()), stats,
                                        ms, floor, sms))
        return r
    return report


def _chase_chain(cluster: int, steps: int) -> dict:
    """chase's chain a round, by instruction class, on the body it was
    launched on (`cluster` CTAs a block, 0 for the global-memory body): on
    the cluster body a local and a remote shared-memory load (both priced
    as LDS) and the ALU ops between them, plus the bulk copy that loads
    the block, once (priced as an L2 hit); on the global-memory body both
    loads from L2 (ld.global.cg)."""
    if cluster:
        return {**CHAINS["chase"], "ldg_l2": 1 / max(steps, 1)}
    return {**CHAINS["chase_global"], "ldg_l2": 2}


def _chain_report(body: str, ml=None, n: int = R * C, cluster: int = 0):
    words = B * n

    def report(stats, ms: float, floor=None) -> dict:
        if stats is None:
            # lane, row, flat: the index and the source in, out
            b_ms, by = cm.bound(12 * words)
            return {"bound_ms": b_ms, "bound_by": by}
        if body == "hops":
            stats, out = stats
        st = stats.cpu().to(torch.float64)
        steps = int(st[:, 1].max())
        # chase: the block in and out; hops: the words its chains visit
        # (two reads and one write a step)
        b_ms, by = cm.bound(8 * words if body == "chase"
                            else 12 * B * STEPS)
        if body == "chase":
            at = st[:, 1] == steps
            per_step = _chase_chain(cluster, steps)
        else:
            # two loads a step; the block with the most first touches (L2)
            # is the longest chain
            touches = hop_first_touches(ml, out)
            cold = int(touches.max())
            at = touches == cold
            cold /= max(steps, 1)
            per_step = {**CHAINS[body], "ldg_l2": cold, "ldg_l1": 2 - cold}
        return {"steps": steps, "longest_chain": steps,
                "ns_per_step": ms * 1e6 / max(steps, 1),
                "cycles_per_step": float((st[:, 0] / st[:, 1].clamp(
                    min=1)).mean()), "bound_ms": b_ms, "bound_by": by,
                **cm.chain_fields(per_step, steps, ms, floor,
                                  st[at, 0].max())}
    return report


def _chase_body(name: str, p: torch.Tensor, sms: int) -> cm.Body:
    """chase with `ROUNDS` rounds on `p` (int32[B, r, c] on the card), its
    route asked of the library (`chase_plan`)."""
    nb, r, c = p.shape

    def run():
        got, stats = gather("chase", p)
        return (got,), stats
    return cm.Body(name, REPLACES["chase"], run,
                   lambda: (gather_plain("chase", p, steps=ROUNDS),),
                   _chase_report(p, chase_plan(r * c), sms),
                   {"B": nb, "R": r, "C": c})


def bodies() -> list[cm.Body]:
    """Every body at the tool's sizes on the card's copy of `inputs()`,
    with `torch.gather` of the same function for lane, row and flat; and
    chase once more at int32[B, GLOBAL_R, C], past the cluster's reach,
    on its global-memory body (`P1 k_chase global`)."""
    d = {k: torch.from_numpy(v).cuda() for k, v in inputs().items()}
    lib = {"lane": (d["x"], 2, d["lane"].to(torch.int64)),
           "row": (d["x"], 1, d["row"].to(torch.int64)),
           "flat": (d["x"].reshape(B, R * C), 1,
                    d["flat"].reshape(B, R * C).to(torch.int64))}
    sms = torch.cuda.get_device_properties(
        d["chase"].device).multi_processor_count
    n = GLOBAL_R * C
    far = torch.from_numpy(np.random.default_rng(4).integers(
        -n, n, (B, GLOBAL_R, C)).astype(np.int32)).cuda()
    out = []
    for body in VARIANTS:
        if body == "chase":
            out.append(_chase_body("P1 k_chase", d["chase"], sms))
            out.append(_chase_body("P1 k_chase global", far, sms))
            continue
        args = _args(body, d)

        def run(body=body, args=args):
            got, stats = gather(body, *args)
            return (got,), ((stats, got) if body == "hops" else stats)

        def plain(body=body, args=args):
            return (gather_plain(body, *args, steps=STEPS if body == "hops"
                                 else ROUNDS),)
        out.append(cm.Body(
            f"P1 k_{body}", REPLACES[body], run, plain,
            _chain_report(body, d["ml"]),
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
