"""Per-stage micro-benchmark of the sort/scan codec: the port's copy of the
JAX package's `tools/fullbench.py` (the reference's fullbench,
tests/fullbench.c:170-516). Times every primitive the sort/scan codec is
built from, then the codec per corpus type, so that a time is
attributable to a stage.

    python -m lz4_tpu_torch.probes.fullbench [--device {cuda,cpu}]
        [--b 32] [--block 65536] [--seconds 1.5] [--stages a,b,...]
        [--level {1,2}]

The first line names the card and its power limit; then one JSON line a
stage, `{"stage", "ms", "host_ms", "net_ms", "MBs"}`:

- `ms`: device time between CUDA events around one call after a sync,
  best of the runs (`probes/_timing.cuda_ms`'s method); null on the CPU;
- `host_ms`: the best wall time of the same calls with a sync (the tool's
  measure, and the clock of PERF.md's step times);
- `net_ms`: `ms` less `noop`'s (`host_ms` less `noop`'s on the CPU);
- `MBs`: the stage's bytes over `ms` (over `host_ms` on the CPU).

A stage runs for `--seconds` of host time, at least 3 and at most 40
calls, after a warm-up. Operands are the tool's: `default_rng(7)` int32
keys and payloads, bytes and gather indices of `N = block + 272`.

Primitives (the tool's :97-164): `noop`, `elementwise`, `cumsum`,
`cummin_rev` (the codec's own `_rcummin`), `sort1/2/7` (a stable
`torch.sort`, then a gather of each payload; `lax.sort` is stable),
`gather_rand`, `gather_u8` (`torch.gather`), and the dependent chains
`scan_16k_u1`, `scan_4k_u4`, `scan_16k_2lane`: one `torch.gather` a hop
in a Python loop, the shape of `encode_sortscan._parse_hops_loop`.

Corpus stages (the tool's :166-234), over text, mixed, rle and random
blocks: `encode_*` (`encode_sortscan.encode_blocks`), `decode_*`
(`decode_sortscan.decode_blocks`), `dparse_*` (its token parse,
`parse_tokens`), `encode_fast_*` (the lighter graph). The encoder is split
as the tool splits the decoder: `etables_*` (`_match_tables`), `ejump_*`
(`_parse_hops`, the pointer-doubling parse that `encode_rows` runs),
`eparse_*` (`_parse_hops_loop`, the JAX module's walk) and `eemit_*`
(`_emit`); each runs over the same chunks of rows as `encode_blocks`.
`--level 1` runs the tool's encode graph (2 candidates, greedy), `--level
2` level 2's (8 candidates, lazy: what `TorchBackend` runs for level 2).

Left out by design: the tool's `sort_gather` (:120-123) and `dfloor_*`
(:219-226), which rest on `decode_jax.sort_gather` and
`CHASE_RMAX_OVERRIDE`, TPU workarounds the port does not have.

Runs on the card unless given `--device cpu` and raises without a GPU
otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from lz4_tpu_torch.block import decode_sortscan, encode_sortscan
from lz4_tpu_torch.block.batch import resolve_device
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text

#: the encoder's padded width class over a block (the tool's N)
PAD = 272
#: the tool's hop counts: (steps, unroll) of `scan_hops`
SCAN_16K = 16386
SCAN_4K = 4097
CORPORA = ("text", "mixed", "rle", "random")
#: corpora whose encode and decode are split into stages (the tool's)
SPLIT = ("text", "mixed", "rle")
FAST = ("text", "mixed")
#: (n_cand, lazy) of the encode graph of each `--level`
LEVELS = {1: (2, False), 2: (8, True)}
PRIMITIVES = ("noop", "elementwise", "cumsum", "cummin_rev", "sort1",
              "sort2", "sort7", "gather_rand", "gather_u8", "scan_16k_u1",
              "scan_4k_u4", "scan_16k_2lane")


def stage_names() -> list[str]:
    """Every stage, in the order of the run."""
    names = list(PRIMITIVES)
    for c in CORPORA:
        names.append(f"encode_{c}")
        if c in SPLIT:
            names += [f"etables_{c}", f"ejump_{c}", f"eparse_{c}",
                      f"eemit_{c}"]
        names.append(f"decode_{c}")
        if c in SPLIT:
            names.append(f"dparse_{c}")
        if c in FAST:
            names.append(f"encode_fast_{c}")
    return names


def operands(B: int, NB: int):
    """The tool's operands as numpy (k32, p1 int32, u8 uint8, gidx int32
    of [B, NB + 272]) and the generator, which the random corpus draws
    from next."""
    N = NB + PAD
    rng = np.random.default_rng(7)
    k32 = rng.integers(0, 2**31, (B, N), dtype=np.int32)
    p1 = rng.integers(0, 2**31, (B, N), dtype=np.int32)
    u8 = rng.integers(0, 256, (B, N), dtype=np.uint8)
    gidx = rng.integers(0, N, (B, N), dtype=np.int32)
    return {"k32": k32, "p1": p1, "u8": u8, "gidx": gidx}, rng


# ------------------------------------------------------------ primitives

def noop(x):
    return x[:1, :1] + 1


def elementwise(x):
    return (x ^ (x >> 3)) + 1


def cumsum(x):
    """int32 running sum, wrapping as jnp's does."""
    return torch.cumsum(x, dim=1, dtype=torch.int32)


def cummin_rev(x):
    return encode_sortscan._rcummin(x)


def sort_payloads(k, *payloads):
    """(sorted keys, each payload in the keys' stable order)."""
    keys, idx = torch.sort(k, dim=-1, stable=True)
    return (keys, *(p.gather(-1, idx) for p in payloads))


def sort7(k, p):
    return sort_payloads(k, p, p + 1, p + 2, p + 3, p + 4, p + 5)


def gather(p, i):
    """p[b, i[b, j]] (i int64)."""
    return p.gather(1, i)


def scan_hops(p, steps: int, unroll: int):
    """The tool's `scan_hops`: `steps * unroll` dependent hops, each one
    gather from the row at the carry + 3; returns the carry int32[B]."""
    N = p.shape[1]
    pe = p[:, : N - 8]
    c = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    for _ in range(steps * unroll):
        c = pe.gather(1, (c + 3).clamp(0, N - 9).long()[:, None])[:, 0]
    return c


def scan_hops2(p, steps: int):
    """The tool's `scan_hops2`: one gather of a 2-lane table a hop."""
    B, N = p.shape
    pe = p[:, : N - 8]
    tab = torch.stack([pe, pe + 1], dim=-1)
    c = torch.zeros(B, dtype=torch.int32, device=p.device)
    for _ in range(steps):
        i = (c + 3).clamp(0, N - 9).long()[:, None, None].expand(B, 1, 2)
        g = tab.gather(1, i)
        c = g[:, 0, 0] - g[:, 0, 1] + 1 + c
    return c


# ---------------------------------------------------- the codec's phases

def corpus(name: str, B: int, NB: int, rng) -> bytes:
    """The tool's corpora of B * NB bytes."""
    if name == "text":
        return gen_text(B * NB, seed=11)
    if name == "mixed":
        return gen_buffer(B * NB, match_prob=0.55, seed=12)
    if name == "rle":
        return b"\x00" * (B * NB)
    return rng.bytes(B * NB)


class EncodeSplit:
    """The sort/scan encoder's phases over `encode_blocks`'s chunks of
    rows (no dict): `tables`, `jump`, `walk`, `emit`; each phase's inputs
    are made once, at construction, by the phases before it."""

    def __init__(self, src, lens, n_cand: int, lazy: bool):
        self.NB = src.shape[1]
        self.kw = {"n_cand": n_cand, "lazy": lazy, "lite": False}
        step = encode_sortscan.chunk_rows(self.NB, src.device)
        self.chunks = [(src[i: i + step], lens[i: i + step])
                       for i in range(0, src.shape[0], step)]
        self.prepared = self.tables()
        self.tokens = self.jump()

    @staticmethod
    def _inputs(src, lens):
        n = lens.long()
        return src.long(), n, torch.zeros_like(n)

    def tables(self):
        return [encode_sortscan._match_tables(*self._inputs(s, n), d0=0,
                                              **self.kw)
                for s, n in self.chunks]

    def jump(self):
        return [encode_sortscan._parse_hops(t[0], t[1], d0=0, cap_n=self.NB)
                for t in self.prepared]

    def walk(self):
        return [encode_sortscan._parse_hops_loop(t[0], t[1], d0=0,
                                                 cap_n=self.NB)
                for t in self.prepared]

    def emit(self):
        return [encode_sortscan._emit(
            *self._inputs(s, n)[:2], tok, t[2], t[3], t[4], d0=0,
            cap_n=self.NB)
            for (s, n), t, tok in zip(self.chunks, self.prepared,
                                      self.tokens)]


def dparse(comp, csz, cap_out: int):
    """`parse_tokens` over `decode_blocks`'s chunks of rows."""
    step = decode_sortscan.chunk_rows(comp.shape[1], cap_out, comp.device)
    return [decode_sortscan.parse_tokens(comp[i: i + step],
                                         csz[i: i + step], cap_out=cap_out,
                                         partial=False)
            for i in range(0, comp.shape[0], step)]


# ------------------------------------------------------------------ run

def run(device, B: int = 32, NB: int = 65536, seconds: float = 1.5,
        stages=None, level: int = 1, emit=print) -> list[dict]:
    """Time the stages (all, or those named in `stages`) on `device`;
    `emit` gets each stage's JSON line. Returns the rows."""
    from lz4_tpu_torch.probes._timing import timed_runs
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    want = set(stages) if stages else set(stage_names())
    rows = []

    def timeit(name, fn, bytes_moved=None):
        if name not in want:
            return
        ms, host, runs = timed_runs(fn, seconds, cuda=cuda)
        clock = ms if cuda else host
        row = {"stage": name, "ms": ms, "host_ms": host, "runs": runs}
        if rows and rows[0]["stage"] == "noop":
            base = rows[0]["ms"] if cuda else rows[0]["host_ms"]
            row["net_ms"] = clock - base
        if bytes_moved:
            row["MBs"] = bytes_moved / 1e6 / clock * 1e3
        rows.append(row)
        emit(json.dumps(row))

    ops, rng = operands(B, NB)
    N = NB + PAD
    t = {k: torch.from_numpy(v).to(dev) for k, v in ops.items()}
    k32, p1, u8 = t["k32"], t["p1"], t["u8"]
    gidx = t["gidx"].long()
    timeit("noop", lambda: noop(k32))
    timeit("elementwise", lambda: elementwise(k32), B * N * 8)
    timeit("cumsum", lambda: cumsum(k32))
    timeit("cummin_rev", lambda: cummin_rev(k32))
    timeit("sort1", lambda: sort_payloads(k32))
    timeit("sort2", lambda: sort_payloads(k32, p1))
    timeit("sort7", lambda: sort7(k32, p1))
    timeit("gather_rand", lambda: gather(p1, gidx), B * N * 4)
    timeit("gather_u8", lambda: gather(u8, gidx), B * N)
    timeit("scan_16k_u1", lambda: scan_hops(p1, SCAN_16K, 1))
    timeit("scan_4k_u4", lambda: scan_hops(p1, SCAN_4K, 4))
    timeit("scan_16k_2lane", lambda: scan_hops2(p1, SCAN_16K))
    del t, k32, p1, u8, gidx

    n_cand, lazy = LEVELS[level]
    lens = torch.full((B,), NB, dtype=torch.int32, device=dev)
    for c in CORPORA:
        blob = corpus(c, B, NB, rng)     # drawn in order: `random` last
        if not any(s.endswith(f"_{c}") for s in want):
            continue
        src = torch.from_numpy(
            np.frombuffer(blob, np.uint8).reshape(B, NB).copy()).to(dev)

        def enc(lite=False, nc=n_cand, lz=lazy):
            return encode_sortscan.encode_blocks(
                src, lens, cap_n=NB, has_dict=False, n_cand=nc, lazy=lz,
                lite=lite)

        timeit(f"encode_{c}", enc, B * NB)
        if c in SPLIT and want & {f"etables_{c}", f"ejump_{c}",
                                  f"eparse_{c}", f"eemit_{c}"}:
            split = EncodeSplit(src, lens, n_cand, lazy)
            timeit(f"etables_{c}", split.tables, B * NB)
            timeit(f"ejump_{c}", split.jump, B * NB)
            timeit(f"eparse_{c}", split.walk, B * NB)
            timeit(f"eemit_{c}", split.emit, B * NB)
            del split
        if want & {f"decode_{c}", f"dparse_{c}"}:
            comp, csz, _ = enc()
            timeit(f"decode_{c}", lambda: decode_sortscan.decode_blocks(
                comp, csz, cap_out=NB, has_dict=False), B * NB)
            if c in SPLIT:
                timeit(f"dparse_{c}", lambda: dparse(comp, csz, NB), B * NB)
            del comp, csz
        if c in FAST:
            # the acceleration graph (--fast >= 4): fewer sort payloads
            timeit(f"encode_fast_{c}", lambda: enc(lite=True, nc=2,
                                                   lz=False), B * NB)
        del src
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--b", type=int, default=32, help="batch of blocks")
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--stages", default="", help="comma filter")
    ap.add_argument("--level", type=int, choices=sorted(LEVELS), default=1,
                    help="the encode graph: 1 the tool's, 2 level 2's")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from lz4_tpu_torch.probes._timing import card
        head = {"card": card(), "kind": torch.cuda.get_device_name(dev)}
    else:
        head = {"card": None, "kind": "cpu (plain torch ops, no card)"}
    print(json.dumps({**head, "device": str(dev), "b": args.b,
                      "block": args.block, "level": args.level}),
          flush=True)
    stages = [s for s in args.stages.split(",") if s]
    bad = set(stages) - set(stage_names())
    if bad:
        ap.error(f"unknown stages {sorted(bad)}")
    rows = run(dev, args.b, args.block, args.seconds, stages, args.level,
               emit=lambda line: print(line, flush=True))
    print("[fullbench] summary:", file=sys.stderr)
    for r in rows:
        t = r["ms"] if r["ms"] is not None else r["host_ms"]
        print(f"[fullbench]   {r['stage']:<16} {t:>10.3f} ms"
              + (f"  {r['MBs']:>10.1f} MB/s" if "MBs" in r else ""),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
