"""P2 and P3 on Hopper: one thread walking a 66,560-byte block in shared
memory, the latency floor under B2's parse chain, and the float32 burn
loop on one SM's lanes or on many SMs (`csrc/probe_walk.cu`); and the
latency build that prices every probe body's chain bound.

    python -m lz4_tpu_torch.probes.walk_probe [--grid G] [--runs 5]
    python -m lz4_tpu_torch.probes.walk_probe --latency

Ports `tools/session_pallas_probe2.py` (`k_smem`, `k_burn`) and
`tools/session_pallas_probe3.py` (`k_a` .. `k_e`) on their data: 8 rows
of 16,640 random int32 words (seed 0), n = 65,536 bytes a row. The
bodies (`walk`'s variants):

- `a` (`P2 k_smem`, a at a grid of 8, is probe2's `k_smem`, the same
  body):
  p += 1 + (byte & 3), acc += byte while p < n, the dependent load chain;
- `b`: p += 3, the load beside the chain; `c`: byte = (p * 7) & 255, no
  load;
- `d`: one thread carrying 8 chains over the row's 8 segments (ILP);
  `d_warp`, the port's own: the 8 chains on 8 lanes of a warp;
- `e`: 26,214 steps of a fixed count, p wrapping at 65,536;
- `arbitrary` / `parallel` (`P2 k_burn`): 16 grid steps of 200,000
  steps of acc = acc * 1.000001 + x[0] in float32, as 16 lanes of one
  warp on one SM (the TPU's "arbitrary" keeps the grid on one core, and
  its steps are independent) or as 16 CTAs (what "megacore" asked on the
  TPU).

`a` tests its exit every step, as B2's parse tests its bounds every
token. `b`, `c` and `d` take theirs off the chain: `b`'s trip count,
ceil(n / 3), is known before it starts, so it runs blocks of `BLOCK`
steps whose loads are in flight together; a step of `c` or `d` advances
p by at most 4, so while p + 4 (`BLOCK` - 1) is inside (every chain's,
for `d`), the next `BLOCK` steps run untested (`d`: without its
per-chain guards), and a tested loop takes the rest (`walk_model`
replays that control flow on the host).

The CTA of grid step g walks row g % 8 (`--grid`, default
`LZ4_TPU_P3_GRID` or 8, probe3's grid). Each body runs at the tool's
counts, and the output of its last timed launch is held against its plain
version on the same inputs (`probes/_common.measure`; the plain loops take
a few torch ops a step, some seconds a body). It reports `ms`
(`probes/_timing.cuda_ms`, one launch after a sync; `ms_back_to_back`
beside it), `ns_per_iter` (ms over every chain step of the grid, the
TPU tool's unit, since its grid ran in order), `ns_per_step` (ms over the
steps of the longest chain: CTAs and burn lanes run at once here),
`cycles_per_step` (the walking thread's or burn lane's clock64 over its
steps) and the chain bound (`_common.chain_fields`: `chain_bound_cycles`,
`chain_bound_ms`, `chain_share`). Prints one JSON line with the card's
name and power limit. Needs one CUDA GPU and nvcc.

`--latency` builds `csrc/probe_walk.cu` with `-DLZ4T_PROBE_LATENCY` and
prints one JSON line: the SM cycles an instruction of each class of
`_common.CLASSES` on a dependent chain (`latencies`: a chain of 8,192
less one of 4,096; each chain's result held against a host replay,
`latency_sink`), the clock
the launch ran at (clock64 over globaltimer) and nvidia-smi's SM clock
read while the card is busy. Every probe's chain bound is priced at
these (`_common.floor`).

`--inflight` times `d` and `b` on the builds of `INFLIGHT`, which vary
the loads one thread has in flight (`d`'s blocks on 2, 4 or 8 of its
chains at a time; `b`'s next block's loads before the current block's
sum), in turns with the default build, and prints one JSON line of SM
cycles a step of the longest chain and the static stall sum of each loop
of the builds' SASS (`inflight`, `probes/sass.py`).

On CPU tensors (or `device="cpu"`) `walk` and `burn` run the plain
versions: torch ops over the grid's rows, a step at a time. The burn
loop rounds each multiply and add to float32 (the kernel's `__fmul_rn`
and `__fadd_rn`), where XLA on the CPU fuses them into one FMA.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from dataclasses import asdict

import numpy as np
import torch

from lz4_tpu_torch.probes import _common as cm

WORDS = 16640
ROWS = 8
N_BYTES = 65536
E_STEPS = 26214
BURN_STEPS = 200000
BURN_GRID = 16
LIB = "probe_walk"
SOURCE = "lz4_tpu_torch/csrc/probe_walk.cu"

WALKS = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4, "d_warp": 5}
#: the steps of b, c and d that run as one block with one exit test
#: (`kBlock` in the kernel)
BLOCK = 8
BURNS = {"arbitrary": 6, "parallel": 7}
#: the latency build's defines and its chains' length
LATENCY = ("LZ4T_PROBE_LATENCY",)
#: the builds that vary the loads in flight, by body and name (the
#: default build first): d's blocks on K of its 8 chains at a time, b's
#: next block's loads before the current block's sum
INFLIGHT = {"d": {"8": (), "4": ("LZ4T_D_INFLIGHT=4",),
                  "2": ("LZ4T_D_INFLIGHT=2",)},
            "b": {"in_order": (), "next_first": ("LZ4T_B_PIPELINE",)}}
LAT_STEPS = 4096
#: the latency kernel's y and z, as its launcher passes them
LAT_Y, LAT_Z = 1, 0x9E3779B9
#: its L1 and L2 rings' entries
LAT_RINGS = (32, 32768)
#: instructions a step on the longest chain, by class (`_common.CLASSES`),
#: read from the SASS of each body's loop (`cuobjdump -sass` of the built
#: library): the loop-carried path from one step's position (or acc) to
#: the next step's, through the compare that decides the loop's exit where
#: that hangs on the data. a, d_warp: (IMAD.IADD,) LDS.U8, LOP3, IADD3,
#: ISETP; e: LDS.U8, LOP3, IADD3, LOP3 (its count runs beside); burn:
#: FMUL, FADD. The blocked walks, a block of 8 steps: b, acc's 4 IADD3s,
#: each adding two bytes (the loads, the count and the exit test are off
#: the chain); c, IMAD, LOP3, IMAD.IADD, then 7 x (IMAD, LOP3, IADD3),
#: the VIADD that restores p + 1 and the exit's ISETP; d, a chain's
#: LDS.U8, LOP3, IMAD.IADD, then 7 x (LDS.U8, LOP3, IADD3), the VIADD
#: that restores p + 1 and one ISETP of the exit, an iteration of its 8
#: chains being one step of each
CHAINS = {"a": {"lds": 1, "alu": 3}, "b": {"alu": 0.5},
          "c": {"imad": 1.125, "alu": 2.125},
          "d": {"lds": 1, "alu": 2.125, "imad": 0.125},
          "d_warp": {"imad": 1, "lds": 1, "alu": 3},
          "e": {"lds": 1, "alu": 3}, "arbitrary": {"fp32": 2},
          "parallel": {"fp32": 2}}
#: body -> (walk variant or burn mode, the TPU kernel it replaces)
BODIES = {
    "P2 k_smem": ("a", "tools/session_pallas_probe2.py:52"),
    "P3 k_a": ("a", "tools/session_pallas_probe3.py:81"),
    "P3 k_b": ("b", "tools/session_pallas_probe3.py:97"),
    "P3 k_c": ("c", "tools/session_pallas_probe3.py:113"),
    "P3 k_d": ("d", "tools/session_pallas_probe3.py:130"),
    "P3 d_warp (the port's own)": ("d_warp",
                                   "tools/session_pallas_probe3.py:130"),
    "P3 k_e": ("e", "tools/session_pallas_probe3.py:166"),
    "P2 k_burn arbitrary": ("arbitrary", "tools/session_pallas_probe2.py:116"),
    "P2 k_burn parallel": ("parallel", "tools/session_pallas_probe2.py:116"),
}

#: kernel launches made by `walk` and `burn` (and nowhere else)
launches = 0


def inputs(rows: int = ROWS, words: int = WORDS, n: int = N_BYTES,
           seed: int = 0):
    """The tools' data: int32[rows, words] in [0, 2^31 - 1) and n a row."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**31 - 1, (rows, words), dtype=np.int32)
    return w, np.full(rows, n, np.int32)


def walk(words, ns, variant: str, *, grid: int | None = None,
         steps: int = E_STEPS, device=None, defines=()):
    """Walk row g % B for each grid step g (see the module docstring).
    words int32[B, W] (W <= 16640; variant e needs W >= 16384), ns
    int32[B] (clamped to [0, 4 W]); `defines` picks a build of the kernel
    (`INFLIGHT`). Returns (acc int32[B], chain steps
    int64[grid], SM cycles int64[grid] or None on the CPU); rows no grid
    step walks hold 0."""
    global launches
    words = cm.as_input(words, device)
    ns = cm.as_input(ns, device)
    dev = cm.same_device(words, ns)
    if variant not in WALKS:
        raise ValueError(f"variant must be one of {sorted(WALKS)}")
    if words.dim() != 2 or not 0 < words.shape[1] <= WORDS \
            or words.shape[0] == 0:
        raise ValueError(f"words must be int32[B, W], 0 < W <= {WORDS}, "
                         f"got {tuple(words.shape)}")
    B, W = words.shape
    if tuple(ns.shape) != (B,):
        raise ValueError(f"ns must be int32[{B}]")
    grid = B if grid is None else int(grid)
    if grid <= 0:
        raise ValueError("grid must be positive")
    if variant == "e" and (4 * W < 65536 or steps < 0):
        raise ValueError("variant e walks 64 KB rows: W >= 16384, "
                         "steps >= 0")
    if dev.type == "cpu":
        acc, taken = walk_plain(words, ns, variant, grid=grid, steps=steps)
        return acc, taken, None
    out = torch.zeros(B, dtype=torch.int32, device=dev)
    stats = torch.empty((grid, 2), dtype=torch.int64, device=dev)
    from lz4_tpu_torch import _build
    fn = _build.load("probe_walk", defines)
    rc = cm.launch(fn, dev, words.data_ptr(), ns.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), B, W, grid, WALKS[variant], steps)
    cm.check_rc(rc, f"probe_walk {variant}")
    launches += 1
    return out, stats[:, 1], stats[:, 0]


def walk_plain(words: torch.Tensor, ns: torch.Tensor, variant: str, *,
               grid: int, steps: int = E_STEPS):
    """Plain version of `walk` on the tensors' own device: (acc, steps)."""
    out, taken = _walk_chains(words, ns, variant, grid=grid, steps=steps)
    return out, taken.sum(1)


def longest_chains(words: torch.Tensor, ns: torch.Tensor, variant: str, *,
                   grid: int, steps: int = E_STEPS) -> torch.Tensor:
    """The steps of each grid step's longest chain (int64[grid]): its
    walk's steps, or the most of d's and d_warp's 8 chains."""
    return _walk_chains(words, ns, variant, grid=grid, steps=steps)[1] \
        .max(1).values


def _walk_chains(words, ns, variant, *, grid, steps):
    """(acc, steps of each of a grid step's chains int64[grid, chains])."""
    dev = words.device
    B, W = words.shape
    rows = torch.arange(grid, device=dev) % B
    w = words.to(torch.int64)[rows]
    n = ns.to(torch.int64)[rows].clamp(0, 4 * W)[:, None]

    def byte_at(p):
        word = w.gather(1, (p // 4).clamp(max=W - 1))
        return (word >> (8 * (p % 4))) & 255

    zero = torch.zeros((grid, 1), dtype=torch.int64, device=dev)
    if variant == "e":
        p, acc = zero, zero
        for _ in range(steps):
            byte = byte_at(p)
            p = (p + 1 + (byte & 3)) % 65536
            acc = acc + byte
        taken = torch.full((grid, 1), max(steps, 0), dtype=torch.int64,
                           device=dev)
    else:
        if variant in ("d", "d_warp"):
            seg = n // 8
            k = torch.arange(8, device=dev)
            p, end = k * seg, (k + 1) * seg
        else:
            p, end = zero, n
        acc = torch.zeros_like(p)
        taken = torch.zeros_like(p)
        for it in itertools.count():
            act = p < end
            if it % 32 == 0 and not bool(act.any()):
                break
            if variant == "c":
                byte = (p * 7) & 255
            else:
                byte = byte_at(p)
            adv = 3 if variant == "b" else 1 + (byte & 3)
            p = torch.where(act, p + adv, p)
            acc = acc + torch.where(act, byte, 0)
            taken = taken + act
    out = torch.zeros(B, dtype=torch.int32, device=dev)
    out[rows] = cm.wrap32(acc.sum(1)).to(torch.int32)
    return out, taken


def walk_model(row, n: int, variant: str, block: int = BLOCK):
    """A host replay of the kernel's control flow for `b`, `c` and `d`
    on one row (int32 words; n clamped as the kernel clamps it): blocks of
    `block` steps with one exit test, then the tested loop, step for
    step. Returns (acc uint32, chain steps, steps taken in blocks)."""
    data = np.ascontiguousarray(row, dtype="<i4").view(np.uint8)
    n = min(max(int(n), 0), data.size)
    reach = 4 * (block - 1)
    m32 = 0xFFFFFFFF
    if variant == "b":
        count = (n + 2) // 3
        acc = k = 0
        while k + block <= count:
            acc += sum(int(data[3 * (k + j)]) for j in range(block))
            k += block
        blocked = k
        while k < count:
            acc += int(data[3 * k])
            k += 1
        return acc & m32, count, blocked
    if variant == "c":
        p = acc = k = 0
        while p < n - reach:
            for _ in range(block):
                byte = (p * 7) & 255
                p += 1 + (byte & 3)
                acc += byte
            k += block
        blocked = k
        while p < n:
            byte = (p * 7) & 255
            p += 1 + (byte & 3)
            acc += byte
            k += 1
        return acc & m32, k, blocked
    if variant != "d":
        raise ValueError("walk_model replays b, c and d")
    seg = n // 8
    p = [k * seg for k in range(8)]
    end = [(k + 1) * seg for k in range(8)]
    a = [0] * 8
    taken = 0
    if seg > reach:
        while True:                       # every chain: p_k + reach < end_k
            for _ in range(block):
                for k in range(8):
                    byte = int(data[p[k]])
                    p[k] += 1 + (byte & 3)
                    a[k] += byte
            taken += 8 * block
            if not all(p[k] < end[k] - reach for k in range(8)):
                break
    blocked = taken
    last = data.size - 1
    while any(p[k] < end[k] for k in range(8)):
        for k in range(8):
            byte = int(data[min(p[k], last)])
            if p[k] < end[k]:
                p[k] += 1 + (byte & 3)
                a[k] += byte
                taken += 1
    return sum(a) & m32, taken, blocked


def burn(x, mode: str, *, steps: int = BURN_STEPS, grid: int = BURN_GRID,
         device=None):
    """k_burn: out[g] = `steps` of acc = acc * 1.000001 + x[0] from 0.0,
    in float32, for g < grid, as the lanes of one CTA ("arbitrary") or as
    `grid` CTAs ("parallel"). x float32[1]. Returns (out float32[grid],
    stats int64[grid, 3] = (SM cycles, steps, CTA) of each grid step's
    loop on the card, else None)."""
    global launches
    x = cm.as_input(x, device, torch.float32)
    dev = cm.same_device(x)
    if mode not in BURNS:
        raise ValueError(f"mode must be one of {sorted(BURNS)}")
    if tuple(x.shape) != (1,) or grid <= 0 or steps < 0:
        raise ValueError("x must be float32[1], grid > 0, steps >= 0")
    if dev.type == "cpu":
        return burn_plain(x, grid=grid, steps=steps), None
    out = torch.empty(grid, dtype=torch.float32, device=dev)
    stats = torch.empty((grid, 3), dtype=torch.int64, device=dev)
    from lz4_tpu_torch import _build
    fn = _build.load("probe_walk")
    rc = cm.launch(fn, dev, x.data_ptr(), None, out.data_ptr(),
                   stats.data_ptr(), 0, 0, grid, BURNS[mode], steps)
    cm.check_rc(rc, f"probe_walk burn {mode}")
    launches += 1
    return out, stats


def burn_plain(x: torch.Tensor, *, grid: int = BURN_GRID,
               steps: int = BURN_STEPS) -> torch.Tensor:
    """Plain version of `burn`: each multiply and add rounded to float32."""
    acc = torch.zeros(grid, dtype=torch.float32, device=x.device)
    c = torch.tensor(1.000001, dtype=torch.float32, device=x.device)
    for _ in range(steps):
        acc = acc * c + x[0]
    return acc


# ---------------------------------------------------------------- on the card

def _ring(n: int, dev, seed: int) -> torch.Tensor:
    """A pointer-chase ring of n int64 entries 128 bytes apart: entry k
    holds the address of the next, in a seeded random order that visits
    all n and comes back to entry 0."""
    buf = torch.zeros(n * 16, dtype=torch.int64, device=dev)
    order = np.random.default_rng(seed).permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[order] = np.roll(order, -1)
    buf[::16] = torch.from_numpy(buf.data_ptr() + nxt * 128).to(dev)
    return buf


def _ring_walk(ring: torch.Tensor, k: int) -> int:
    """The address `k` steps along `ring` from its entry 0."""
    buf, base = ring.cpu().numpy()[::16], ring.data_ptr()
    at = 0
    for _ in range(k):
        at = (int(buf[at]) - base) // 128
    return base + 128 * at


def latency_sink(l1: torch.Tensor, l2: torch.Tensor,
                 steps: int = LAT_STEPS) -> list[int]:
    """A host replay of what the latency kernel leaves of each chain in
    its sink (uint32[7]): every chain runs `steps` and then 2 * `steps`
    steps (`price`), the rings after one untimed lap, the shuffle's lane
    0 after swapping with lane 1."""
    n = 3 * steps
    m32 = 0xFFFFFFFF
    p = 0                                  # LDS: s[i] = ((i + 97) & 1023) * 4
    for _ in range(n):
        p = ((p // 4 + 97) & 1023) * 4
    alu = imad = LAT_Z
    for _ in range(n):
        alu = (alu + LAT_Y + (alu & 3)) & LAT_Z
        imad = (imad * (LAT_Y + 2) + LAT_Z) & m32
    f = np.float32(LAT_Y)
    a = np.float32(1.000001) * np.float32(LAT_Y)
    for _ in range(n):
        f = np.float32(f * a) + np.float32(0.5)
    lane0 = 0 if n % 2 == 0 else LAT_Z
    return [p, _ring_walk(l1, l1.numel() // 16 + n) & m32,
            _ring_walk(l2, l2.numel() // 16 + n) & m32, alu, imad,
            int(np.float32(f).view(np.uint32)), lane0]


def latencies(steps: int = LAT_STEPS) -> dict:
    """The latency build on the current CUDA device (see the module
    docstring): `cycles`, class -> SM cycles an instruction, and
    `kernel_mhz`, the clock the launch ran at (clock64 over
    globaltimer). Raises where a chain's result differs from its host
    replay (`latency_sink`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the latency build needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    l1, l2 = (_ring(n, dev, seed) for seed, n in enumerate(LAT_RINGS, 1))
    sink = torch.zeros(8, dtype=torch.int32, device=dev)
    stats = torch.zeros((8, 2), dtype=torch.int64, device=dev)
    from lz4_tpu_torch import _build
    rc = cm.launch(_build.load(LIB, LATENCY), dev, l1.data_ptr(),
                   l2.data_ptr(), sink.data_ptr(), stats.data_ptr(),
                   LAT_RINGS[0], LAT_RINGS[1], 1, 8, steps)
    cm.check_rc(rc, "probe_walk latency")
    got = [v & 0xFFFFFFFF for v in sink.cpu().tolist()[:7]]
    want = latency_sink(l1, l2, steps)
    if got != want:
        raise RuntimeError(f"latency chains differ from their host replay: "
                           f"{got} != {want}")
    st = stats.cpu().tolist()
    return {"cycles": {k: st[i][0] / st[i][1]
                       for i, k in enumerate(cm.CLASSES)},
            "kernel_mhz": st[7][0] / max(st[7][1], 1) * 1e3}


def _walk_report(kind: str, longest=None):
    """The report of walk `kind`; `longest()` gives the steps of each
    grid step's longest chain where they are not the steps it took (d,
    d_warp: the most of its 8 chains)."""
    def report(stats, ms: float, floor=None) -> dict:
        taken, cycles = (t.cpu() for t in stats)
        total = int(taken.sum())
        chains = taken if longest is None else longest()
        chain = int(chains.max())
        # the function needs the bytes its chains visit, ns and acc
        b_ms, by = cm.bound(total + 8 * ROWS)
        return {"steps": total, "longest_chain": chain,
                "ns_per_iter": ms * 1e6 / max(total, 1),
                "ns_per_step": ms * 1e6 / max(chain, 1),
                "cycles_per_step": float((cycles.to(torch.float64)
                                          / taken.clamp(min=1)).mean()),
                "bound_ms": b_ms, "bound_by": by,
                **cm.chain_fields(CHAINS[kind], chain, ms, floor,
                                  cycles[chains == chain].max())}
    return report


def _burn_report(kind: str):
    def report(stats, ms: float, floor=None) -> dict:
        st = stats.cpu().to(torch.float64)
        total = int(st[:, 1].sum())
        chain = int(st[:, 1].max())       # every lane or CTA runs one
        b_ms, by = cm.bound(4 + 4 * st.shape[0], 2.0 * total)
        return {"steps": total, "longest_chain": chain,
                "ctas": int(st[:, 2].max()) + 1,
                "ns_per_iter": ms * 1e6 / max(total, 1),
                "ns_per_step": ms * 1e6 / max(chain, 1),
                "cycles_per_step": float((st[:, 0] / st[:, 1].clamp(min=1))
                                         .mean()),
                "bound_ms": b_ms, "bound_by": by,
                **cm.chain_fields(CHAINS[kind], chain, ms, floor,
                                  st[st[:, 1] == chain, 0].max())}
    return report


def bodies(grid: int = ROWS) -> list[cm.Body]:
    """Every body at the tool's counts, on the card's copy of `inputs()`
    (`smem` at a grid of 8, the walks of probe3 at `grid`)."""
    w, n = inputs()
    words, ns = torch.from_numpy(w).cuda(), torch.from_numpy(n).cuda()
    x = torch.ones(1, dtype=torch.float32, device="cuda")
    out = []
    for name, (kind, replaces) in BODIES.items():
        if kind in BURNS:
            def run(kind=kind):
                got, stats = burn(x, kind)
                return (got,), stats
            out.append(cm.Body(
                name, replaces, run, lambda: (burn_plain(x),),
                _burn_report(kind), {"steps": BURN_STEPS,
                                     "grid": BURN_GRID}))
            continue
        g = ROWS if name == "P2 k_smem" else grid

        def run(kind=kind, g=g):
            acc, taken, cycles = walk(words, ns, kind, grid=g)
            return (acc, taken), (taken, cycles)

        def plain(kind=kind, g=g):
            return walk_plain(words, ns, kind, grid=g)

        def longest(kind=kind, g=g):
            return longest_chains(words.cpu(), ns.cpu(), kind, grid=g)
        out.append(cm.Body(
            name, replaces, run, plain,
            _walk_report(kind, longest if kind in ("d", "d_warp") else None),
            {"steps": E_STEPS, "grid": g} if kind == "e"
            else {"n": N_BYTES, "grid": g}))
    return out


def _latency_cli() -> int:
    """--latency: one JSON line of the latency build's prices."""
    if not torch.cuda.is_available():
        print("walk_probe: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch.probes._timing import card
    print(json.dumps({"probe": "latency", "card": card(), "steps": LAT_STEPS,
                      **asdict(cm.floor())}), flush=True)
    return 0


def inflight(turns: int = 2) -> dict:
    """--inflight: each build of `INFLIGHT` on the probe's inputs at a grid
    of 8, `turns` times over in turns (the builds in order, then in
    reverse), each launch's acc and steps held to the plain version.
    Returns, by body and build, its defines, the SM cycles a step of the
    longest chain at each launch (d: an iteration of its 8 chains) and
    the loops of its SASS with 8 loads or more (`sass.library_loops`:
    instructions, loads, the static stall sum, the loads' barriers)."""
    from lz4_tpu_torch import _build
    from lz4_tpu_torch.probes import sass
    w, n = inputs()
    words, ns = torch.from_numpy(w).cuda(), torch.from_numpy(n).cuda()
    out = {}
    for kind, builds in INFLIGHT.items():
        for defines in builds.values():
            _build.build([LIB], defines)
        want = walk_plain(words.cpu(), ns.cpu(), kind, grid=ROWS)
        chains = (longest_chains(words.cpu(), ns.cpu(), kind, grid=ROWS)
                  if kind == "d" else want[1])
        chain = int(chains.max())
        got = {name: [] for name in builds}
        for t in range(2 * turns):
            for name in (builds if t % 2 == 0 else reversed(builds)):
                acc, taken, cycles = walk(words, ns, kind, grid=ROWS,
                                          defines=builds[name])
                if not (torch.equal(acc.cpu(), want[0])
                        and torch.equal(taken.cpu(), want[1])):
                    raise AssertionError(f"walk {kind} {name} != plain")
                got[name].append(float(cycles.cpu()[chains == chain].max())
                                 / chain)
        out[kind] = {name: {"defines": list(builds[name]),
                            "cycles_per_step": got[name],
                            "loops": sass.library_loops(LIB, builds[name],
                                                        "walk_kernel", 8)}
                     for name in builds}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int,
                    default=int(os.environ.get("LZ4_TPU_P3_GRID", ROWS)))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--latency", action="store_true",
                    help="print the latency build's prices only")
    ap.add_argument("--inflight", action="store_true",
                    help="time d and b on the builds that vary their "
                    "loads in flight only")
    args = ap.parse_args(argv)
    if args.latency:
        return _latency_cli()
    if args.inflight:
        if not torch.cuda.is_available():
            print("walk_probe: no CUDA device", file=sys.stderr)
            return 2
        from lz4_tpu_torch.probes._timing import card
        print(json.dumps({"probe": "inflight", "card": card(),
                          "bodies": inflight()}), flush=True)
        return 0
    return cm.cli("walk_probe", LIB, lambda: bodies(args.grid),
                  lambda: launches, args.runs, grid=args.grid)


if __name__ == "__main__":
    sys.exit(main())
