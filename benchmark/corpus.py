"""The benchmark's corpus: independent blocks of seeded synthetic data
whose classes follow a corpus file (`benchmark/corpora/<name>.json`).

A vectorized rewrite of the program's `utils/datagen.py` `gen_buffer`
(which loops over sequences in Python): each block is a run of
operations, a literal run of bytes drawn from the class's symbols by a
Zipf law, or a match that repeats earlier bytes of the block at a
log-uniform offset. Every draw is made in bulk with one
`torch.Generator` on the run's device; a match is resolved by pointer
doubling (each byte points at the byte it copies, and the pointers are
composed until every one reaches a literal), so no Python loop runs per
byte or per operation.

The classes are laid out in strata of `stratum_blocks` blocks, each
stratum holding every class in its share (largest remainders) in an
order drawn from the seed: every seed gives the same amount of each
class, in another order. The same seed on the same kind of device gives
the same bytes.
"""
from __future__ import annotations

import json
import math
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: blocks generated together: bounds the pointer arrays' memory
CHUNK_BLOCKS = 256


def load_spec(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "corpora", f"{name}.json")) as f:
        return json.load(f)


def stratum_counts(shares, stratum: int) -> list[int]:
    """Blocks of each class in a stratum: shares × stratum rounded by
    largest remainders, so that the counts sum to the stratum."""
    raw = [s * stratum for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[: stratum - sum(counts)]:
        counts[i] += 1
    return counts


def block_classes(spec: dict, n_blocks: int,
                  gen: torch.Generator) -> torch.Tensor:
    """The class index of each block: int64[n_blocks] (on the CPU)."""
    stratum = spec["stratum_blocks"]
    if n_blocks % stratum:
        raise ValueError(f"{n_blocks} blocks are not whole strata of "
                         f"{stratum}")
    counts = stratum_counts([c["share"] for c in spec["classes"]], stratum)
    base = torch.repeat_interleave(torch.arange(len(counts)),
                                   torch.tensor(counts))
    parts = []
    for _ in range(n_blocks // stratum):
        perm = torch.randperm(stratum, generator=gen,
                              device=gen.device).cpu()
        parts.append(base[perm])
    return torch.cat(parts)


def _symbols(cls: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(symbols uint8[S], cdf float64[S]) of a class's literal law:
    symbol r (0-based rank) has weight 1 / (r + 1) ** zipf."""
    sym = bytes.fromhex(cls["symbols_hex"]) if "symbols_hex" in cls \
        else cls["symbols"].encode("latin-1")
    ranks = torch.arange(1, len(sym) + 1, dtype=torch.float64)
    w = ranks.pow(-float(cls["zipf"]))
    cdf = (w.cumsum(0) / w.sum()).to(device)
    cdf[-1] = 1.0
    return torch.tensor(list(sym), dtype=torch.uint8, device=device), cdf


def _mean_op(cls: dict) -> float:
    lo, hi = cls["lit_run"]
    m = cls["match_len"]
    a = float(m["alpha"])
    mean_match = m["min"] + (m["scale"] / (a - 1) if a > 1 else m["max"])
    p = cls["match_prob"]
    return p * min(mean_match, m["max"]) + (1 - p) * (lo + hi) / 2


def _gen_blocks(cls: dict, m: int, n: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """m blocks of n bytes of one class: uint8[m, n] on `device`."""
    lo, hi = cls["lit_run"]
    ml = cls["match_len"]
    k = int(n / min(_mean_op(cls), (lo + hi) / 2) * 1.5) + 64
    is_match = torch.rand(m, k, generator=gen, device=device) \
        < cls["match_prob"]
    lit_len = torch.randint(lo, hi + 1, (m, k), generator=gen,
                            device=device)
    u = torch.rand(m, k, generator=gen, device=device,
                   dtype=torch.float64).clamp_min(1e-12)
    # numpy's pareto(a) is U ** (-1/a) - 1
    match_len = (ml["scale"] * (u.pow(-1.0 / ml["alpha"]) - 1) + ml["min"]
                 ).floor().clamp(ml["min"], ml["max"]).long()
    length = torch.where(is_match, match_len, lit_len)
    ends = length.cumsum(1)
    starts = ends - length
    is_match &= starts >= cls["min_history"]
    reach = starts.clamp(min=1, max=cls["max_offset"]).double()
    v = torch.rand(m, k, generator=gen, device=device, dtype=torch.float64)
    off = torch.exp(v * torch.log(reach + 1)).floor().long()
    off = torch.minimum(off.clamp_min(1), reach.long())
    pos = torch.arange(n, device=device).expand(m, n).contiguous()
    op = torch.searchsorted(ends, pos, right=True)
    inside = op < k
    op = op.clamp(max=k - 1)
    copies = is_match.gather(1, op) & inside
    src = torch.where(copies, pos - off.gather(1, op), pos)
    del op, copies, inside
    while True:
        nxt = src.gather(1, src)
        if torch.equal(nxt, src):
            break
        src = nxt
    sym, cdf = _symbols(cls, device)
    draw = torch.rand(m, n, generator=gen, device=device,
                      dtype=torch.float64)
    lit = sym[torch.searchsorted(cdf, draw).clamp(max=sym.numel() - 1)]
    return lit.gather(1, src)


def make_corpus(spec: dict, seed: int, n_blocks: int, block_bytes: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(data uint8[n_blocks, block_bytes] on `device`, class index
    int64[n_blocks] on the CPU) from `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    classes = block_classes(spec, n_blocks, gen)
    data = torch.empty((n_blocks, block_bytes), dtype=torch.uint8,
                       device=device)
    for ci, cls in enumerate(spec["classes"]):
        rows = torch.nonzero(classes == ci).flatten()
        for s in range(0, rows.numel(), CHUNK_BLOCKS):
            part = rows[s: s + CHUNK_BLOCKS]
            data[part.to(device)] = _gen_blocks(cls, part.numel(),
                                                block_bytes, gen, device)
    return data, classes
