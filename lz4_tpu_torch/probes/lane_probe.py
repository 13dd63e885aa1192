"""P4 on Hopper: the per-lane gathers of a 128-lane wavefront decoder and
its mock row step, the primitives under B3's parse
(`csrc/probe_lane.cu`).

    python -m lz4_tpu_torch.probes.lane_probe [--nit 65536] [--runs 5]

Ports `tools/session_r4probe2.py` on its data (seed 7, int32 in [0,
2^30)):

- the correctness gathers of `kern` (`gather`): `a0` (out[r, c] =
  src[idx[r, c] mod rows, c]) at 8, 64 and 512 rows, and at 8 rows with
  indices out of range (`a0_8_mod`, the TPU's mod semantics); `a1`
  (out[r, c] = src[r, idx[r, c] mod 128]); `2step` (every row gets
  src[(w >> 7) mod 8, w mod 128], w = idx[0, c]);
- the loop kernel of `mk_loop` (`loop`): `nit` steps of acc = body(acc,
  i) from acc = src[:8, :], with the bodies `base`, `a0_8`, `a1_8`,
  `2step` (8 rows), `a0_big` at 64, 512 and 4096 rows (nit, nit / 4,
  nit / 32 steps, as the tool) and `onehot` (512 rows, nit / 4). The
  TPU's one-hot multiply and sum over 512 rows selects one row of each
  lane, so on the card `onehot` is that select, one indexed load from
  the lane's column in shared memory (a0_big's step); its plain version
  keeps the one-hot arithmetic;
- `wave_kern` (`wave`): nit / 8 mock row steps, each a two-step fetch
  pair, some 40 ALU ops, a gather from a 512-row history of each lane and
  a row store into it. The TPU's history starts undefined; the port
  zero-fills it.

The gathers spread their output over the card: a thread writes 4
consecutive words of a row (16-byte index loads and stores, 4-byte ones
where a view's start is not 16-byte aligned), reading its 4 source words
from global memory through L1/L2, rows / 8 CTAs of 256 threads. They
launch through the library's CPython entry (`csrc/pyentry.h`): one C call
checks the inputs, allocates the output with `torch.empty_like` and
launches; where a check fails or the tensors sit off the current device
it returns None and `gather` runs its Python checks (which raise) or
enters the device. The loops and the wave launch through ctypes. In
`base`, `a0_8` and `a1_8` the 8 rows of a lane are 8 independent chains,
which the TPU ran as the sublanes of one vreg: each thread carries one
(row, lane) chain, CTA r row r and its thread t lane t (`chain_of`), so a
warp is 32 lanes of one row and the 1024 chains take 8 CTAs of 128
threads, each with its own copy of src[:8, :] in shared memory. The other
loops and the wave take one word for all 8 rows from row 0, one chain a
lane: they keep a lane's column in shared memory, `lanes_per_cta(rows)`
lanes a CTA.

Each runs at the tool's counts (`--nit`, 65,536 as the tool's
`LZ4_TPU_P42_NIT`), and the output of its last timed launch is held
against its plain version on the same inputs (`probes/_common.measure`;
the plain loops take a few torch ops a step, some seconds a body). It
reports `ms` (`probes/_timing.cuda_ms`; `ms_back_to_back` beside it),
`ns_per_step` (ms over the steps), `cycles_per_step` (clock64 of CTA 0's
longest chain over the steps), for the loops and the wave the chain bound
(`_common.chain_fields`), for the gathers the host's and the card's time a call
(`host_us`, `device_us`) and, for the gathers with indices in range,
`torch.gather` (a0, a1) or `torch.take` (2step) of the same function on
the same inputs, timed on the same methods (`library_ms`,
`library_ms_back_to_back`, `library_host_us`, `library_device_us`).
Prints one JSON line with the card's name and power limit. Needs one CUDA
GPU and nvcc.

On CPU tensors (or `device="cpu"`) the functions run the plain versions:
torch ops on the (8, 128) carry, a step at a time, in int64 wrapped to
int32 as jnp's int32 arithmetic wraps.
"""
from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.probes import _common as cm

LANES = 128
NIT = 65536
WAVE_ROWS = 512
LIB = "probe_lane"
SOURCE = "lz4_tpu_torch/csrc/probe_lane.cu"

GATHERS = {"a0": 0, "a1": 1, "2step": 2}
LOOPS = {"base": 10, "a0_8": 11, "a1_8": 12, "2step": 13, "a0_big": 14,
         "onehot": 15}
#: the loops with one (row, lane) chain a thread, in CTAs of a row
CHAIN_LOOPS = ("base", "a0_8", "a1_8")
ROWS = 8
WAVE = 20
#: instructions a step on the longest chain, by class (`_common.CLASSES`),
#: read from the SASS of each body's loop (`cuobjdump -sass` of the built
#: library; nvcc unrolls some loops by 2, 4 or 16, hence the fractions):
#: base (one chain a thread) IADD3 or, one step in four, IMAD.IADD,
#: then LOP3; a0_8 (one chain a thread) LEA, LOP3, LDS, LOP3; a1_8 (one
#: chain a thread) LEA, LOP3, IMAD (the row's start), LDS, LOP3; 2step
#: LOP3, VIADD, LEA or IMAD.SHL, LOP3, LDS; a0_big and onehot LOP3, IADD3
#: or IMAD.IADD, LOP3, IMAD, LEA, LDS; wave the two-step fetch (VIADD,
#: IMAD.SHL, VIADD, LOP3, LDS), the parse ALU (SHF, then 5 rounds of LOP3,
#: IMAD.IADD, LOP3, ISETP, SEL, IMAD.IADD), the history gather (VIADD,
#: IMAD.SHL, LOP3, IMAD.IADD, LEA, LDS) and the combine (LOP3, PRMT, LOP3,
#: LOP3)
CHAINS = {"base": {"alu": 1.75, "imad": 0.25}, "a0_8": {"alu": 3, "lds": 1},
          "a1_8": {"alu": 3, "imad": 1, "lds": 1},
          "2step": {"alu": 3.75, "imad": 0.25, "lds": 1},
          "a0_big": {"alu": 3.75, "imad": 1.25, "lds": 1},
          "onehot": {"alu": 3.75, "imad": 1.25, "lds": 1},
          "wave": {"alu": 31, "imad": 13, "lds": 2}}
_FILE = "tools/session_r4probe2.py"
#: body -> (function, kind, rows, steps as a fraction of nit, replaces)
BODIES = {
    "c_a0_8": ("gather", "a0", 8, None, f"{_FILE}:81"),
    "c_a0_8_mod": ("gather", "a0", 8, None, f"{_FILE}:81"),
    "c_a1_8": ("gather", "a1", 8, None, f"{_FILE}:81"),
    "c_2step": ("gather", "2step", 8, None, f"{_FILE}:119"),
    "c_a0_64": ("gather", "a0", 64, None, f"{_FILE}:81"),
    "c_a0_512": ("gather", "a0", 512, None, f"{_FILE}:81"),
    "t_base": ("loop", "base", 8, 1, f"{_FILE}:191"),
    "t_a0_8": ("loop", "a0_8", 8, 1, f"{_FILE}:197"),
    "t_a1_8": ("loop", "a1_8", 8, 1, f"{_FILE}:204"),
    "t_2step": ("loop", "2step", 8, 1, f"{_FILE}:211"),
    "t_a0_64": ("loop", "a0_big", 64, 1, f"{_FILE}:218"),
    "t_a0_512": ("loop", "a0_big", 512, 4, f"{_FILE}:218"),
    "t_a0_4096": ("loop", "a0_big", 4096, 32, f"{_FILE}:218"),
    "t_onehot": ("loop", "onehot", 512, 4, f"{_FILE}:233"),
    "t_wave": ("wave", None, 8, 8, f"{_FILE}:248"),
}

#: the library's Python entry (`csrc/pyentry.h`), once loaded
_entry = None


def _load_entry():
    global _entry
    _entry = _build.module(LIB).gather
    return _entry


#: kernel launches made by `gather`, `loop` and `wave` (and nowhere else)
launches = 0


def lanes_per_cta(rows: int) -> int:
    """Lanes a CTA of the row-0 loops and the wave takes: its columns of
    `rows` rows fit in 128 KB."""
    return max(1, min(LANES, 32768 // rows))


def chain_of(cta: int, thread: int) -> tuple[int, int]:
    """The (row, lane) chain that `thread` of `cta` carries in the
    `CHAIN_LOOPS`: CTAs of a row, 128 threads, one lane each."""
    g = cta * LANES + thread
    return g // LANES, g % LANES


def loop_ctas(body: str, rows: int) -> int:
    """The CTAs (stats rows) of loop `body` at `rows` rows."""
    return ROWS if body in CHAIN_LOOPS else LANES // lanes_per_cta(rows)


def _launch(variant: str, code: int, dev, src, out, stats, rows, nit):
    rc = cm.launch(_build.load(LIB), dev, src.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), rows, code, nit)
    cm.check_rc(rc, f"probe_lane {variant}")
    global launches
    launches += 1


def _check_src(src, min_rows=8):
    if src.dim() != 2 or src.shape[1] != LANES:
        raise ValueError(f"src must be int32[rows, {LANES}], got "
                         f"{tuple(src.shape)}")
    rows = src.shape[0]
    if rows < min_rows or rows > 32768 or rows & (rows - 1):
        raise ValueError(f"rows must be a power of two in [{min_rows}, "
                         f"32768], got {rows}")
    return rows


def gather(kind: str, src, idx, *, device=None) -> torch.Tensor:
    """`kern`'s gathers: int32[rows, 128] src and idx -> int32[rows, 128]
    (see the module docstring; a1 and 2step take 8 rows)."""
    global launches
    code = GATHERS.get(kind)
    if (code is not None and type(src) is torch.Tensor
            and type(idx) is torch.Tensor and src.is_cuda):
        # the checks, the output and the launch in one C call; None where
        # a check fails or the device is not the current one
        out = (_entry or _load_entry())(src, idx, code)
        if out is not None:
            launches += 1
            return out
    if code is None:
        raise ValueError(f"kind must be one of {sorted(GATHERS)}")
    src, idx = cm.as_input(src, device), cm.as_input(idx, device)
    dev = cm.same_device(src, idx)
    rows = _check_src(src)
    if idx.shape != src.shape or (kind != "a0" and rows != 8):
        raise ValueError("idx must have src's shape; a1 and 2step take "
                         "8 rows")
    if dev.type == "cpu":
        return gather_plain(kind, src, idx)
    with torch.cuda.device(dev):
        out = (_entry or _load_entry())(src, idx, code)
    if out is None:
        raise RuntimeError(f"probe_lane {kind}: the kernel refused {dev}")
    launches += 1
    return out


def gather_plain(kind: str, src: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    rows = src.shape[0]
    i = idx.to(torch.int64)
    if kind == "a0":
        return torch.gather(src, 0, i.remainder(rows))
    if kind == "a1":
        return torch.gather(src, 1, i.remainder(LANES))
    w = i[0]
    g = src[torch.div(w, LANES, rounding_mode="floor").remainder(8),
            w.remainder(LANES)]
    return g.expand(rows, LANES).contiguous()


def loop(body: str, src, nit: int, *, device=None):
    """`mk_loop`'s kernel: `nit` steps of acc = body(acc, i) from acc =
    src[:8, :]. src int32[rows, 128] (rows 8 but for a0_big and onehot).
    Returns (acc int32[8, 128], stats int64[`loop_ctas`, 2] = (SM cycles
    of each CTA's longest chain, steps) on the card, else None)."""
    if body not in LOOPS:
        raise ValueError(f"body must be one of {sorted(LOOPS)}")
    src = cm.as_input(src, device)
    dev = cm.same_device(src)
    rows = _check_src(src)
    if nit < 0:
        raise ValueError("nit must be >= 0")
    if dev.type == "cpu":
        return loop_plain(body, src, nit), None
    out = torch.empty((8, LANES), dtype=torch.int32, device=dev)
    stats = torch.empty((loop_ctas(body, rows), 2), dtype=torch.int64,
                        device=dev)
    _launch(f"loop_{body}", LOOPS[body], dev, src, out, stats, rows, nit)
    return out, stats


def loop_plain(body: str, src: torch.Tensor, nit: int) -> torch.Tensor:
    rows = src.shape[0]
    s = src.to(torch.int64)
    s8 = s[:8]
    acc = s8.clone()
    riota = torch.arange(rows, device=src.device)[:, None]
    for i in range(nit):
        if body == "base":
            acc = acc ^ ((acc + i) & 7)
        elif body == "a0_8":
            acc = acc ^ torch.gather(s8, 0, (acc + i) & 7)
        elif body == "a1_8":
            acc = acc ^ torch.gather(s8, 1, (acc + i) & (LANES - 1))
        elif body == "2step":
            acc = acc ^ two_step_plain(s8, (acc + i) & 1023)
        elif body == "a0_big":
            idx = ((acc[0:1] + i) % rows).expand(rows, LANES)
            acc = acc ^ torch.gather(s, 0, idx)[:8]
        else:
            idx = (acc[0:1] + i) % rows
            oh = (riota == idx).to(torch.int64)
            acc = acc ^ cm.wrap32((oh * s).sum(0, keepdim=True))
    return acc.to(torch.int32)


def two_step_plain(s8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """two_step (r4probe2:119) on int64: row 0 of w picks, for each lane,
    the word s8[(w // 128) % 8, w % 128] (floor division and mod), which
    every row gets."""
    w0 = w[0]
    g = s8[torch.div(w0, LANES, rounding_mode="floor").remainder(8),
           w0.remainder(LANES)]
    return g.expand(8, LANES)


def wave(src, nw: int, *, device=None):
    """`wave_kern`: `nw` mock row steps from acc = src, with a zeroed
    512-row history a lane. src int32[8, 128]. Returns (acc int32[8,
    128], stats int64[2, 2] on the card, else None)."""
    src = cm.as_input(src, device)
    dev = cm.same_device(src)
    if tuple(src.shape) != (8, LANES):
        raise ValueError(f"src must be int32[8, {LANES}]")
    if nw < 0:
        raise ValueError("nw must be >= 0")
    if dev.type == "cpu":
        return wave_plain(src, nw), None
    out = torch.empty((8, LANES), dtype=torch.int32, device=dev)
    stats = torch.empty((LANES // lanes_per_cta(WAVE_ROWS), 2),
                        dtype=torch.int64, device=dev)
    _launch("wave", WAVE, dev, src, out, stats, 8, nw)
    return out, stats


def wave_plain(src: torch.Tensor, nw: int) -> torch.Tensor:
    s8 = src.to(torch.int64)
    acc = s8.clone()
    hist = torch.zeros((WAVE_ROWS, LANES), dtype=torch.int64,
                       device=src.device)
    lanes = torch.arange(LANES, device=src.device)
    w32 = cm.wrap32
    for i in range(nw):
        w = (acc + i) & 1023
        g0 = two_step_plain(s8, w)
        g1 = two_step_plain(s8, (w + 1) & 1023)
        t = g0
        for sh in (4, 8, 12, 16, 20):
            t = t ^ ((g1 >> sh) & 255)
            t = w32(t + ((g0 >> sh) & 15))
            t = torch.where((t & 1) > 0, w32(t + g1), w32(t - g0))
        mg = hist[w32(t[0] + i) % WAVE_ROWS, lanes].expand(8, LANES)
        v = torch.where((t & 2) > 0, mg, g0)
        v = w32(v << 8) | (mg & 255)
        v = v ^ (g1 & t)
        hist[i & (WAVE_ROWS - 1)] = v[0]
        acc = acc ^ v
    return acc.to(torch.int32)


# ---------------------------------------------------------------- on the card

def inputs(seed: int = 7) -> dict:
    """Each body's src (and idx for the gathers), drawn in the tool's
    order: each gather's idx, then its src; then the src of each timed
    body."""
    rng = np.random.default_rng(seed)
    d = {}
    for body, (fn, kind, rows, _, _) in BODIES.items():
        if fn != "gather":
            continue
        if body == "c_a0_8_mod":          # out of range: mod semantics
            idx = (d["c_a0_8"][1] + 16).astype(np.int32)
        else:
            hi = {"2step": 1024, "a1": LANES}.get(kind, rows)
            idx = rng.integers(0, hi, (rows, LANES)).astype(np.int32)
        src = rng.integers(0, 2**30, (rows, LANES), dtype=np.int32)
        d[body] = (src, idx)
    for body, (fn, _, rows, _, _) in BODIES.items():
        if fn != "gather":
            d[body] = (rng.integers(0, 2**30, (rows, LANES),
                                    dtype=np.int32), None)
    return d


def _report(body: str, nit: int):
    fn, kind, rows, frac, _ = BODIES[body]
    words = rows * LANES

    def report(stats, ms: float, floor=None) -> dict:
        if fn == "gather":
            b_ms, by = cm.bound(12 * words)   # src and idx in, out
            return {"bound_ms": b_ms, "bound_by": by}
        steps = nit // frac                   # every lane's chain
        b_ms, by = cm.bound(4 * words + 4 * 8 * LANES)  # src in, acc out
        return {"steps": steps, "longest_chain": steps,
                "ns_per_step": ms * 1e6 / max(steps, 1),
                "cycles_per_step": float(stats[0, 0]) / max(steps, 1),
                "bound_ms": b_ms, "bound_by": by,
                **cm.chain_fields(CHAINS[kind or fn], steps, ms, floor,
                                  stats[:, 0].max())}
    return report


def _library(body: str, src, idx):
    """One PyTorch call of the body's function on its inputs, where the
    indices are in range: torch.gather for a0 and a1, torch.take of the
    flat 8 x 128 window (w = (w // 128) * 128 + w % 128) for 2step."""
    fn, kind, rows, _, _ = BODIES[body]
    if fn != "gather" or body == "c_a0_8_mod":
        return None
    if kind == "2step":
        flat = idx[:1].to(torch.int64).expand(rows, LANES).contiguous()
        return partial(torch.take, src, flat)
    return partial(torch.gather, src, GATHERS[kind], idx.to(torch.int64))


def bodies(nit: int = NIT) -> list[cm.Body]:
    """Every body at the tool's counts (loops and wave at nit / their
    fraction of it) on the card's copy of `inputs()`."""
    d = inputs()
    out = []
    for body, (fn, kind, _, frac, replaces) in BODIES.items():
        src, idx = (None if a is None else torch.from_numpy(a).cuda()
                    for a in d[body])
        if fn == "gather":
            def run(kind=kind, src=src, idx=idx):
                return (gather(kind, src, idx),), None

            def plain(kind=kind, src=src, idx=idx):
                return (gather_plain(kind, src, idx),)
            count = {"rows": src.shape[0]}
        elif fn == "loop":
            def run(kind=kind, src=src, n=nit // frac):
                acc, stats = loop(kind, src, n)
                return (acc,), stats

            def plain(kind=kind, src=src, n=nit // frac):
                return (loop_plain(kind, src, n),)
            count = {"steps": nit // frac}
        else:
            def run(src=src, n=nit // frac):
                acc, stats = wave(src, n)
                return (acc,), stats

            def plain(src=src, n=nit // frac):
                return (wave_plain(src, n),)
            count = {"steps": nit // frac}
        out.append(cm.Body(f"P4 {body}", replaces, run, plain,
                           _report(body, nit), count,
                           _library(body, src, idx), host=fn == "gather"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nit", type=int, default=NIT)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    return cm.cli("lane_probe", LIB, lambda: bodies(args.nit),
                  lambda: launches, args.runs, nit=args.nit)


if __name__ == "__main__":
    sys.exit(main())
