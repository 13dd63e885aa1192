"""Wave-tier block decode: kernel B3 (`csrc/decode_wave.cu`) and its plain
PyTorch version, with the batch and linked entry points.

The host C splitter (`lz4_tpu_torch.native.blockcodec.wave_split`) re-lays
each LZ4 block stream into the wave arena: piece k holds exactly 1024
decoded bytes (the last piece may hold fewer) at arena byte k*1088, in a
chain-free grammar with capped lengths. The splitter validates the stream
completely, so the kernel runs no format checks.

Contract of `wave_decode`: arenas uint8[B, NP, 1088], out_lens int32[B],
optionally hist uint8[B, 65536] (the 64 KB before each stream's position
0, right-aligned) -> out uint8[B, NP*1024]. out[b, :out_lens[b]] is the
decoded stream; bytes past it are unspecified. `wave_decode_batch` and
`wave_decode_linked` keep the signatures of the JAX package's functions
(`lz4_tpu.block.decode_wave`), with `device` in place of the TPU knobs,
and take any number of streams in one launch per round.
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import resolve_device

WOUT = 1024            # decoded bytes per piece
WCAP = 1088            # arena bytes per piece slot
HIST = 65536           # linked history window
LINKED_PIECES = HIST // WOUT

#: kernel launches made by `wave_decode` (and nowhere else)
launches = 0


def _check(arenas, out_lens, hist):
    if arenas.dtype != torch.uint8 or arenas.dim() != 3 or \
            arenas.shape[2] != WCAP:
        raise TypeError("arenas must be uint8[B, NP, 1088]")
    B, NP, _ = arenas.shape
    if out_lens.dtype != torch.int32 or tuple(out_lens.shape) != (B,):
        raise TypeError("out_lens must be int32[B]")
    if hist is not None and (hist.dtype != torch.uint8
                             or tuple(hist.shape) != (B, HIST)):
        raise TypeError("hist must be uint8[B, 65536]")
    for name, t in (("arenas", arenas), ("out_lens", out_lens),
                    ("hist", hist)):
        if t is None:
            continue
        if t.device != arenas.device:
            raise ValueError(f"{name} is on {t.device}, not {arenas.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wave_decode(arenas: torch.Tensor, out_lens: torch.Tensor,
                hist: torch.Tensor | None = None) -> torch.Tensor:
    """Decode wave arenas (see the module docstring). CPU tensors run the
    plain version; CUDA tensors launch B3."""
    global launches
    _check(arenas, out_lens, hist)
    B, NP, _ = arenas.shape
    out = torch.empty((B, NP * WOUT), dtype=torch.uint8,
                      device=arenas.device)
    res, n = _build.launch(
        "decode_wave", "B3", arenas.device,
        lambda: wave_decode_plain(arenas, out_lens, hist), out, arenas,
        out_lens, hist, out, B, NP)
    launches += n
    return res


# --------------------------------------------------------------------------
# plain version: the same piece-by-piece parse, in Python
# --------------------------------------------------------------------------

def _source(ob: bytearray, hb: bytes | None, start: int, n: int) -> bytes:
    """Bytes at output positions [start, start+n), start < 0 reaching
    into the history (0 where there is none)."""
    if start >= 0:
        return bytes(ob[start: start + n])
    lo = min(0, start + n)
    pre = (hb[HIST + start: HIST + lo] if hb is not None and start >= -HIST
           else bytes(lo - start))
    return pre + bytes(ob[0: max(0, start + n)])


def _decode_stream(row: bytes, n_out: int, hb: bytes | None,
                   cap_out: int) -> bytearray:
    ob = bytearray(cap_out)
    for k in range(-(-n_out // WOUT)):
        c, c_end = k * WCAP, (k + 1) * WCAP
        o, o_end = k * WOUT, min((k + 1) * WOUT, n_out)

        def rd(q, c_end=c_end):
            return row[q] if q < c_end else 0

        while o < o_end and c < c_end:
            tok = rd(c)
            c += 1
            lit, mn = tok >> 4, tok & 15
            if lit == 15:
                lit += rd(c)
                c += 1
            take = max(0, min(lit, o_end - o))
            seg = row[c: min(c + take, c_end)]
            ob[o: o + take] = seg + bytes(take - len(seg))
            c += lit
            o += lit
            if mn == 0:
                continue
            off = rd(c) | (rd(c + 1) << 8)
            c += 2
            mlen = mn
            if mn == 15:
                mlen += rd(c)
                c += 1
            take = max(0, min(mlen, o_end - o))
            if off > 0 and take:
                if off >= mlen:
                    ob[o: o + take] = _source(ob, hb, o - off, take)
                else:
                    period = _source(ob, hb, o - off, off)
                    ob[o: o + take] = (period * (-(-take // off)))[:take]
            o += mlen
    return ob


def wave_decode_plain(arenas: torch.Tensor, out_lens: torch.Tensor,
                      hist: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of B3 on CPU tensors: the kernel's parse in
    Python over each stream's arena (bytes it never writes are 0)."""
    B, NP, _ = arenas.shape
    cap_out = NP * WOUT
    out = torch.zeros((B, cap_out), dtype=torch.uint8)
    a_np = arenas.cpu().numpy()
    lens = out_lens.cpu().tolist()
    h_np = None if hist is None else hist.cpu().numpy()
    for b in range(B):
        n_out = min(max(lens[b], 0), cap_out)
        hb = None if h_np is None else h_np[b].tobytes()
        ob = _decode_stream(a_np[b].tobytes(), n_out, hb, cap_out)
        out[b] = torch.frombuffer(ob, dtype=torch.uint8)
    return out


# --------------------------------------------------------------------------
# CPU model of the kernel's order
# --------------------------------------------------------------------------

class WaveParallelModel:
    """What one CTA of B3 does with one stream. Phase A: `warps` warps
    take the pieces w, w+W, ... in a seeded random interleaving, one
    sequence a step, each writing the piece's literal bytes into the tile
    and, for every output byte, its source: itself for a literal, and for
    a byte copied from the history row (whose value it writes), the
    position it copies for a match byte (base + (i mod offset) when the
    match overlaps itself). A byte no sequence writes is its own source.
    Phase B: pointer jumping; each round replaces every source by its
    source's source, the bytes taken in a random order and updated in
    place (as the kernel's threads do), until a round changes nothing
    (`rounds` counts the rounds, the last included; `max_rounds` cuts
    them short, for tests). Then every byte takes its source's value.
    Asserts that every write lies inside the stream's output bytes, that
    every source is a lower position (so the rounds end) and that every
    byte read at the end is a terminal that phase A wrote (the last
    check only with `strict`, i.e. on valid arenas)."""

    def __init__(self, warps: int = 16, seed: int = 0, strict: bool = True,
                 max_rounds: int | None = None):
        self.W = warps
        self.rng = np.random.default_rng(seed)
        self.strict = strict
        self.max_rounds = max_rounds
        self.rounds = 0

    def decode(self, row: bytes, n_out: int, hb: bytes | None,
               n_pieces: int) -> bytearray:
        cap_out = n_pieces * WOUT
        n_out = min(max(n_out, 0), cap_out)
        pieces = -(-n_out // WOUT)
        T = bytearray(cap_out)
        written = bytearray(cap_out)
        S = list(range(cap_out))

        def put(x, o_end, src, v=None):
            assert 0 <= x < o_end <= n_out, f"write at {x} outside the row"
            assert 0 <= src <= x, f"source {src} of byte {x} not below it"
            S[x] = src
            if v is not None:
                T[x] = v
                written[x] = 1

        def piece(k):
            c, c_end = k * WCAP, (k + 1) * WCAP
            o, o_end = k * WOUT, min((k + 1) * WOUT, n_out)

            def rd(q):
                return row[q] if q < c_end else 0

            while o < o_end and c < c_end:
                tok = rd(c)
                c += 1
                lit, mn = tok >> 4, tok & 15
                if lit == 15:
                    lit += rd(c)
                    c += 1
                for i in range(min(lit, o_end - o)):
                    put(o + i, o_end, o + i, rd(c + i))
                c += lit
                o += lit
                mlen = 0
                if mn:
                    off = rd(c) | (rd(c + 1) << 8)
                    c += 2
                    mlen = mn
                    if mn == 15:
                        mlen += rd(c)
                        c += 1
                    if off > 0:
                        base = o - off
                        for i in range(min(mlen, o_end - o)):
                            x = base + (i % off if off < mlen else i)
                            if x >= 0:
                                put(o + i, o_end, x)
                            else:
                                put(o + i, o_end, o + i,
                                    hb[HIST + x] if hb is not None
                                    and x >= -HIST else 0)
                o += mlen
                yield

        def warp(w):
            for k in range(w, pieces, self.W):
                yield from piece(k)

        actors = [warp(w) for w in range(self.W)]
        while actors:
            a = actors[int(self.rng.integers(len(actors)))]
            try:
                next(a)
            except StopIteration:
                actors.remove(a)
        # pointer jumping, in place, the positions in a random order
        while self.max_rounds is None or self.rounds < self.max_rounds:
            changed = False
            for j in self.rng.permutation(n_out).tolist():
                t = S[S[j]]
                if t != S[j]:
                    S[j] = t
                    changed = True
            self.rounds += 1
            if not changed:
                break
        out = bytearray(cap_out)
        for j in range(n_out):
            s = S[j]
            assert not self.strict or (S[s] == s and written[s]), \
                f"byte {j} reads {s}, not a written terminal"
            out[j] = T[s]
        return out


def wave_decode_model(arenas, out_lens, hist=None, *, warps=16, seed=0,
                      strict=True, max_rounds=None):
    """`wave_decode_plain`'s contract computed by `WaveParallelModel`
    (bytes past out_lens are 0). Returns (out, rounds per stream)."""
    B, NP, _ = arenas.shape
    out = torch.zeros((B, NP * WOUT), dtype=torch.uint8)
    a_np = arenas.cpu().numpy()
    lens = out_lens.cpu().tolist()
    h_np = None if hist is None else hist.cpu().numpy()
    rounds = []
    for b in range(B):
        m = WaveParallelModel(warps, seed + b, strict, max_rounds)
        hb = None if h_np is None else h_np[b].tobytes()
        out[b] = torch.frombuffer(m.decode(a_np[b].tobytes(), lens[b], hb,
                                           NP), dtype=torch.uint8)
        rounds.append(m.rounds)
    return out, rounds


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def wave_decode_batch(arenas, out_lens, *, device=None) -> list[bytes]:
    """Decode B wave-split streams in one launch. arenas uint8[B, NP,
    1088] and out_lens int32[B] from the splitter; returns the decoded
    byte strings."""
    dev = resolve_device(device)
    lens = np.asarray(out_lens, np.int32)
    out = wave_decode(
        torch.from_numpy(np.ascontiguousarray(arenas, np.uint8)).to(dev),
        torch.from_numpy(lens).to(dev)).cpu().numpy()
    return [out[i, : lens[i]].tobytes() for i in range(out.shape[0])]


def wave_decode_linked(streams: list[list[bytes]], *,
                       device=None) -> list[bytes]:
    """Decode linked streams: each is a list of LZ4 block streams whose
    matches may reach up to 64 KB back across block boundaries (-BD
    frames). Every non-final block must decode to exactly 64 KB; the
    final one may be short. Round t decodes block t of every stream in
    one launch, with round t-1's output tensor as its history, so the
    64 KB carry stays on the device. Returns each stream's output."""
    from lz4_tpu_torch.native import blockcodec as bc
    dev = resolve_device(device)
    B = len(streams)
    if B == 0:
        return []
    rounds = max(len(s) for s in streams)
    hist = None
    outs, lens = [], np.zeros((rounds, B), np.int64)
    for t in range(rounds):
        arenas = np.zeros((B, LINKED_PIECES, WCAP), np.uint8)
        out_lens = np.zeros(B, np.int32)
        for j, s in enumerate(streams):
            if t >= len(s):
                continue
            r = bc.wave_split(s[t], max_pieces=LINKED_PIECES, out_cap=HIST,
                              hist_len=HIST if t > 0 else 0)
            if r is None:
                raise ValueError(f"stream {j} block {t} not wave-able")
            arena, out_len = r
            if t + 1 < len(s) and out_len != HIST:
                raise ValueError(f"stream {j}: non-final block decodes to "
                                 f"{out_len} != 64KB")
            arenas[j, : arena.shape[0]] = arena
            out_lens[j] = out_len
        hist = wave_decode(torch.from_numpy(arenas).to(dev),
                           torch.from_numpy(out_lens).to(dev), hist)
        outs.append(hist)
        lens[t] = out_lens
    flat = torch.stack(outs, 1).cpu().numpy()          # [B, rounds, 64K]
    return [b"".join(flat[j, t, : lens[t, j]].tobytes()
                     for t in range(len(streams[j])))
            for j in range(B)]
