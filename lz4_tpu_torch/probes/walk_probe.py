"""P2 and P3 on Hopper: one thread walking a 66,560-byte block in shared
memory, the latency floor under B2's parse chain, and the float32 burn
loop on one CTA or many (`csrc/probe_walk.cu`).

    python -m lz4_tpu_torch.probes.walk_probe [--grid G] [--runs 5]

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
  steps of acc = acc * 1.000001 + x[0] in float32, in order on one CTA
  or as 16 CTAs (what "megacore" asked on the TPU).

The CTA of grid step g walks row g % 8 (`--grid`, default
`LZ4_TPU_P3_GRID` or 8, probe3's grid). Each body runs at the tool's
counts, and the output of its last timed launch is held against its plain
version on the same inputs (`probes/_common.measure`; the plain loops take
a few torch ops a step, some seconds a body). It reports `ms`
(`probes/_timing.cuda_ms`, one launch after a sync; `ms_back_to_back`
beside it), `ns_per_iter` (ms over every chain step of the grid, the
TPU tool's unit, since its grid ran in order), `ns_per_step` (ms over the
steps of the longest chain: CTAs run at once here), and
`cycles_per_step` (the walking thread's clock64 over its steps). Prints
one JSON line with the card's name and power limit. Needs one CUDA GPU
and nvcc.

On CPU tensors (or `device="cpu"`) `walk` and `burn` run the plain
versions: torch ops over the grid's rows, a step at a time. The burn
loop rounds each multiply and add to float32 (the kernel's `__fmul_rn`
and `__fadd_rn`), where XLA on the CPU fuses them into one FMA.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys

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
BURNS = {"arbitrary": 6, "parallel": 7}
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
         steps: int = E_STEPS, device=None):
    """Walk row g % B for each grid step g (see the module docstring).
    words int32[B, W] (W <= 16640; variant e needs W >= 16384), ns
    int32[B] (clamped to [0, 4 W]). Returns (acc int32[B], chain steps
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
    fn = _build.load("probe_walk")
    rc = cm.launch(fn, dev, words.data_ptr(), ns.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), B, W, grid, WALKS[variant], steps)
    cm.check_rc(rc, f"probe_walk {variant}")
    launches += 1
    return out, stats[:, 1], stats[:, 0]


def walk_plain(words: torch.Tensor, ns: torch.Tensor, variant: str, *,
               grid: int, steps: int = E_STEPS):
    """Plain version of `walk` on the tensors' own device: (acc, steps)."""
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
        taken = torch.full((grid,), max(steps, 0), dtype=torch.int64,
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
        taken = taken.sum(1)
    out = torch.zeros(B, dtype=torch.int32, device=dev)
    out[rows] = cm.wrap32(acc.sum(1)).to(torch.int32)
    return out, taken


def burn(x, mode: str, *, steps: int = BURN_STEPS, grid: int = BURN_GRID,
         device=None):
    """k_burn: out[g] = `steps` of acc = acc * 1.000001 + x[0] from 0.0,
    in float32, for g < grid, on one CTA in order ("arbitrary") or on
    `grid` CTAs ("parallel"). x float32[1]. Returns (out float32[grid],
    SM cycles of each CTA int64 or None on the CPU)."""
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
    ctas = 1 if mode == "arbitrary" else grid
    stats = torch.empty((ctas, 2), dtype=torch.int64, device=dev)
    from lz4_tpu_torch import _build
    fn = _build.load("probe_walk")
    rc = cm.launch(fn, dev, x.data_ptr(), None, out.data_ptr(),
                   stats.data_ptr(), 0, 0, grid, BURNS[mode], steps)
    cm.check_rc(rc, f"probe_walk burn {mode}")
    launches += 1
    return out, stats[:, 0]


def burn_plain(x: torch.Tensor, *, grid: int = BURN_GRID,
               steps: int = BURN_STEPS) -> torch.Tensor:
    """Plain version of `burn`: each multiply and add rounded to float32."""
    acc = torch.zeros(grid, dtype=torch.float32, device=x.device)
    c = torch.tensor(1.000001, dtype=torch.float32, device=x.device)
    for _ in range(steps):
        acc = acc * c + x[0]
    return acc


# ---------------------------------------------------------------- on the card

def _walk_report(stats, ms: float) -> dict:
    taken, cycles = (t.cpu() for t in stats)
    total, longest = int(taken.sum()), int(taken.max())
    # the function needs the bytes its chains visit, ns and acc
    b_ms, by = cm.bound(total + 8 * ROWS)
    return {"steps": total, "longest_chain": longest,
            "ns_per_iter": ms * 1e6 / max(total, 1),
            "ns_per_step": ms * 1e6 / max(longest, 1),
            "cycles_per_step": float((cycles.to(torch.float64)
                                      / taken.clamp(min=1)).mean()),
            "bound_ms": b_ms, "bound_by": by}


def _burn_report(cycles, ms: float) -> dict:
    cycles = cycles.cpu().to(torch.float64)
    total = BURN_STEPS * BURN_GRID
    per_cta = total // cycles.numel()
    b_ms, by = cm.bound(4 + 4 * BURN_GRID, 2.0 * total)
    return {"steps": total, "longest_chain": per_cta,
            "ns_per_iter": ms * 1e6 / total,
            "ns_per_step": ms * 1e6 / per_cta,
            "cycles_per_step": float((cycles / per_cta).mean()),
            "bound_ms": b_ms, "bound_by": by}


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
                got, cycles = burn(x, kind)
                return (got,), cycles
            out.append(cm.Body(
                name, replaces, run, lambda: (burn_plain(x),), _burn_report,
                {"steps": BURN_STEPS, "grid": BURN_GRID}))
            continue
        g = ROWS if name == "P2 k_smem" else grid

        def run(kind=kind, g=g):
            acc, taken, cycles = walk(words, ns, kind, grid=g)
            return (acc, taken), (taken, cycles)

        def plain(kind=kind, g=g):
            return walk_plain(words, ns, kind, grid=g)
        out.append(cm.Body(
            name, replaces, run, plain, _walk_report,
            {"steps": E_STEPS, "grid": g} if kind == "e"
            else {"n": N_BYTES, "grid": g}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int,
                    default=int(os.environ.get("LZ4_TPU_P3_GRID", ROWS)))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    return cm.cli("walk_probe", LIB, lambda: bodies(args.grid),
                  lambda: launches, args.runs, grid=args.grid)


if __name__ == "__main__":
    sys.exit(main())
