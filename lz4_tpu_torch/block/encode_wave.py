"""Wave-tier block encode: kernel B4 (`csrc/encode_wave.cu`), the lockstep
match finder, its plain PyTorch version and a model of the kernel's warp
lane by lane (`WaveLockstepModel`, for the tests), with the batch and
linked entry points and the Python emitter.

The match finder scans each block once and writes one decision word per
4 input bytes: off | sub << 16 | (mlen - 4) << 18 for a match of mlen
bytes that ends at position 4 * row + sub, else 0. The host C emitter
(`lz4_tpu_torch.native.blockcodec.wave_emit_decisions`) turns decisions
into standard LZ4 block streams, with offsets capped at `max_dist` and
the end-of-block rules re-checked; `emit_from_decisions` is the same
emitter in Python, kept as its oracle.

Contract of `find_matches`: inp uint8[B, n_rows*4] (block b in
inp[b, :lens[b]]), lens int32[B], optionally hist uint8[B, wr*4] (each
block's history tail, right-aligned) with hlen int32[B] -> decisions
int32[B, n_rows], one row per block: the transpose of the JAX kernel's
(n_rows, 128) array (`lz4_tpu.block.encode_wave`). The entry points keep the
JAX functions' signatures, with `device` in place of the TPU knobs, and
take any number of blocks in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import resolve_device

HASH_BITS = 10             # log2 buckets per block (2 candidates each)
MAX_DIST = 2048            # default offset cap
MAX_MLEN = 16384           # force-end bound (14-bit mlen field)
KNUTH = 2654435761
#: widest table the kernel holds in shared memory (128 KB)
MAX_HASH_BITS = 15

#: kernel launches made by `find_matches` (and nowhere else)
launches = 0


def rows_for(max_len: int) -> int:
    """Decision rows for a group whose longest block is `max_len` bytes
    (lz4_tpu encode_wave.py:409-413, 467-470): 1024, 4096 or 16384."""
    n_rows = 1024
    while n_rows * 4 < max_len:
        n_rows *= 4
    return n_rows


def history_rows(max_dist: int, n_rows: int) -> int:
    """Rows of history the linked mode sees: enough for every offset up
    to max_dist, clamped to the block tier."""
    return min(max_dist // 4 + 2, n_rows + 1)


def pack_input(blocks, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Blocks -> (inp uint8[B, n_rows*4] zero-padded, lens int32[B])."""
    inp = np.zeros((len(blocks), n_rows * 4), np.uint8)
    lens = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        if len(b) > n_rows * 4:
            raise ValueError(f"block {i} holds {len(b)} bytes > "
                             f"{n_rows * 4}")
        inp[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return inp, lens


def pack_history(streams: list[list[bytes]], t: int,
                 wr: int) -> tuple[np.ndarray, np.ndarray]:
    """History tails for round t: (hist uint8[B, wr*4] right-aligned,
    hlen int32[B]). Joins only the trailing blocks that cover wr*4
    bytes."""
    hist = np.zeros((len(streams), wr * 4), np.uint8)
    hlen = np.zeros(len(streams), np.int32)
    if t > 0:
        for j, s in enumerate(streams):
            parts, got = [], 0
            for b in reversed(s[:t]):
                parts.append(b)
                got += len(b)
                if got >= wr * 4:
                    break
            hs = b"".join(reversed(parts))[-(wr * 4):]
            if hs:
                hist[j, wr * 4 - len(hs):] = np.frombuffer(hs, np.uint8)
                hlen[j] = len(hs)
    return hist, hlen


def _check(inp, lens, hist, hlen, hash_bits):
    if not 1 <= hash_bits <= MAX_HASH_BITS:
        raise ValueError(f"hash_bits must be in 1..{MAX_HASH_BITS}, got "
                         f"{hash_bits}")
    if inp.dtype != torch.uint8 or inp.dim() != 2 or inp.shape[1] % 4:
        raise TypeError("inp must be uint8[B, n_rows*4]")
    if inp.shape[1] > 65536:
        raise ValueError("blocks above 64 KB do not fit 16-bit positions")
    B = inp.shape[0]
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise TypeError("lens must be int32[B]")
    if (hist is None) != (hlen is None):
        raise ValueError("hist and hlen go together")
    if hist is not None:
        if hist.dtype != torch.uint8 or hist.dim() != 2 or \
                hist.shape[0] != B or hist.shape[1] % 4 or \
                hist.shape[1] < 8:
            raise TypeError("hist must be uint8[B, wr*4] with wr >= 2")
        if hlen.dtype != torch.int32 or tuple(hlen.shape) != (B,):
            raise TypeError("hlen must be int32[B]")
    for name, t in (("inp", inp), ("lens", lens), ("hist", hist),
                    ("hlen", hlen)):
        if t is None:
            continue
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, not {inp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def find_matches(inp: torch.Tensor, lens: torch.Tensor,
                 hist: torch.Tensor | None = None,
                 hlen: torch.Tensor | None = None, *,
                 max_dist: int = MAX_DIST,
                 hash_bits: int = HASH_BITS) -> torch.Tensor:
    """Decisions int32[B, n_rows] (see the module docstring). CPU tensors
    run the plain version; CUDA tensors launch B4."""
    global launches
    _check(inp, lens, hist, hlen, hash_bits)
    if inp.is_cuda and inp.data_ptr() % 4:
        raise ValueError("inp must be 4-byte aligned")
    B, n_rows = inp.shape[0], inp.shape[1] // 4
    dec = torch.zeros((B, n_rows), dtype=torch.int32, device=inp.device)
    res, n = _build.launch(
        "encode_wave", "B4", inp.device,
        lambda: find_matches_plain(inp, lens, hist, hlen, max_dist=max_dist,
                                   hash_bits=hash_bits),
        dec, inp, lens, hist, hlen, dec, B, n_rows,
        0 if hist is None else hist.shape[1] // 4, int(max_dist),
        int(hash_bits))
    launches += n
    return res


# --------------------------------------------------------------------------
# plain version: the same scan, position by position, in Python
# --------------------------------------------------------------------------

def _scan_one(x: np.ndarray, n: int, hb: np.ndarray | None, hl: int,
              n_rows: int, max_dist: int, hash_bits: int) -> list[int]:
    """Decisions of one block: x its input row (zero past n), hb its
    history row (None without history)."""
    shift = 32 - hash_bits
    table = [0xFFFFFFFF] * (1 << hash_bits)
    dec = [0] * n_rows
    linked = hb is not None
    if linked:
        wr = hb.size // 4
        h4 = (hb[:-3].astype(np.uint32) | (hb[1:-2].astype(np.uint32) << 8)
              | (hb[2:-1].astype(np.uint32) << 16)
              | (hb[3:].astype(np.uint32) << 24))
        hh = ((h4.astype(np.uint64) * KNUTH) & 0xFFFFFFFF) >> shift
        for j in range(4 * (wr - 1)):
            p = -4 * wr + j
            if p >= -hl:
                e = int(hh[j])
                table[e] = ((table[e] << 16) | (p & 0xFFFF)) & 0xFFFFFFFF
        hbl = hb.tolist()
    q_end = min(n, x.size)
    xp = np.zeros(q_end + 3, np.uint32)
    xp[:q_end] = x[:q_end]
    cur = xp[:q_end] | (xp[1:q_end + 1] << 8) | (xp[2:q_end + 2] << 16) \
        | (xp[3:q_end + 3] << 24)
    hq_all = (((cur.astype(np.uint64) * KNUTH) & 0xFFFFFFFF)
              >> shift).tolist()
    xl = x[:q_end].tolist()
    mode = cand = a = 0
    for q in range(q_end):
        h = hq_all[q]
        ent = table[h]
        c1, c2 = ent & 0xFFFF, ent >> 16
        if linked:
            d1, d2 = (q - c1) & 0xFFFF, (q - c2) & 0xFFFF
            ok1 = 1 <= d1 <= max_dist and d1 <= q + hl and c1 != 0xFFFF
            ok2 = 1 <= d2 <= max_dist and d2 <= q + hl and c2 != 0xFFFF
            cnd = q - (d1 if ok1 else d2)
        else:
            ok1 = 1 <= q - c1 <= max_dist
            ok2 = 1 <= q - c2 <= max_dist
            cnd = c1 if ok1 else c2
        if q + 4 <= n:
            table[h] = ((ent << 16) | q) & 0xFFFFFFFF
        if mode == 0 and (ok1 or ok2) and q <= n - 12:
            cand, a, mode = cnd, q, 1
        if mode == 1:
            src = cand + q - a
            if src >= 0:
                mb = xl[src] if src < q_end else 0
            else:
                hj = src + 4 * wr if linked else -1
                mb = hbl[hj] if hj >= 0 else 0
            mlen = q - a
            if not (mb == xl[q] and q < n - 5 and mlen < MAX_MLEN + 3):
                if mlen >= 4:
                    dec[q >> 2] = ((a - cand) | ((q & 3) << 16)
                                   | ((mlen - 4) << 18))
                mode = 0
    return dec


def find_matches_plain(inp: torch.Tensor, lens: torch.Tensor,
                       hist: torch.Tensor | None = None,
                       hlen: torch.Tensor | None = None, *,
                       max_dist: int = MAX_DIST,
                       hash_bits: int = HASH_BITS) -> torch.Tensor:
    """Plain PyTorch version of B4 on CPU tensors: the kernel's scan in
    Python, one block at a time."""
    B, row = inp.shape
    n_rows = row // 4
    x_np = inp.cpu().numpy()
    n_l = lens.cpu().tolist()
    h_np = None if hist is None else hist.cpu().numpy()
    hl_l = [0] * B if hlen is None else hlen.cpu().tolist()
    out = np.zeros((B, n_rows), np.uint32)
    for b in range(B):
        out[b] = _scan_one(x_np[b], n_l[b],
                           None if h_np is None else h_np[b], hl_l[b],
                           n_rows, max_dist, hash_bits)
    return torch.from_numpy(out.view(np.int32))


# --------------------------------------------------------------------------
# the kernel's warp, lane by lane (for the tests)
# --------------------------------------------------------------------------

WARP = 32


class WaveLockstepModel:
    """What one warp of B4 does with one block, lane by lane: 32
    positions a step. `insert_step` is the table's probe and insert for
    32 positions at once (peer groups of equal hash among the inserting
    lanes, the nearest and second-nearest lower peers standing for the
    entry a lane would have read in serial order, the highest inserting
    lane of each group writing back); `run` then takes the start / verify
    / end machine over the step: each startable lane first measures its
    agreement (the bytes its start would verify, to the step's end), so
    a start ends where its agreement or the block's end says without a
    byte read; only a match carried into the step verifies by a ballot
    over byte compares. `steps` and `rounds` count the warp steps and the
    rounds of the machine."""

    def __init__(self, x, n, hb, hl, max_dist, hash_bits):
        self.x = x                     # the row, uint8
        self.n = n
        self.hb = hb                   # history row or None
        self.hl = hl
        self.max_dist = max_dist
        self.shift = 32 - hash_bits
        self.table = [0xFFFFFFFF] * (1 << hash_bits)
        self.steps = 0
        self.rounds = 0

    def _hash(self, v):
        return ((v * KNUTH) & 0xFFFFFFFF) >> self.shift

    def insert_step(self, hs, pos16, ins):
        """Probe and insert 32 lanes at once: hs the lanes' hashes, pos16
        their 16-bit positions, ins whether each inserts. Returns the
        entry each lane sees (the serial order's)."""
        seen = []
        for lane in range(WARP):
            peers = [j for j in range(lane) if ins[j] and hs[j] == hs[lane]]
            old = self.table[hs[lane]]
            if len(peers) >= 2:
                ent = pos16[peers[-1]] | (pos16[peers[-2]] << 16)
            elif peers:
                ent = pos16[peers[-1]] | ((old & 0xFFFF) << 16)
            else:
                ent = old
            seen.append(ent)
        for lane in range(WARP):
            if ins[lane] and not any(ins[j] and hs[j] == hs[lane]
                                     for j in range(lane + 1, WARP)):
                self.table[hs[lane]] = ((seen[lane] << 16)
                                        | pos16[lane]) & 0xFFFFFFFF
        return seen

    def warmup(self):
        """Seed the table from the history tail, 32 positions a step."""
        hb = self.hb
        wr = hb.size // 4
        m = 4 * (wr - 1)
        for j0 in range(0, m, WARP):
            js = [j0 + k for k in range(WARP)]
            ps = [-4 * wr + j for j in js]
            ins = [j < m and p >= -self.hl for j, p in zip(js, ps)]
            hs = [self._hash(int(hb[j]) | (int(hb[j + 1]) << 8)
                             | (int(hb[j + 2]) << 16)
                             | (int(hb[j + 3]) << 24)) if j < m else 0
                  for j in js]
            self.insert_step(hs, [p & 0xFFFF for p in ps], ins)

    def byte(self, src, q_end):
        if src >= 0:
            return int(self.x[src]) if src < q_end else 0
        if self.hb is None:
            return 0
        hj = src + self.hb.size
        return int(self.hb[hj]) if hj >= 0 else 0

    def run(self, n_rows):
        x, n = self.x, self.n
        q_end = min(n, x.size)
        linked = self.hb is not None
        if linked:
            self.warmup()
        xp = np.zeros(x.size + 2 * WARP, np.uint32)
        xp[:q_end] = x[:q_end]
        dec = [0] * n_rows
        mode = cand = a = 0
        for base in range(0, q_end, WARP):
            self.steps += 1
            qs = [base + k for k in range(WARP)]
            active = [q < q_end for q in qs]
            cur4 = [int(xp[q] | (xp[q + 1] << 8) | (xp[q + 2] << 16)
                        | (xp[q + 3] << 24)) if q < q_end else 0
                    for q in qs]
            hs = [self._hash(v) for v in cur4]
            ins = [act and q + 4 <= n for act, q in zip(active, qs)]
            seen = self.insert_step(hs, [q & 0xFFFF for q in qs], ins)
            ok, cnd = [], []
            for q, ent in zip(qs, seen):
                c1, c2 = ent & 0xFFFF, ent >> 16
                if linked:
                    d1, d2 = (q - c1) & 0xFFFF, (q - c2) & 0xFFFF
                    ok1 = (1 <= d1 <= self.max_dist and d1 <= q + self.hl
                           and c1 != 0xFFFF)
                    ok2 = (1 <= d2 <= self.max_dist and d2 <= q + self.hl
                           and c2 != 0xFFFF)
                    cnd.append(q - (d1 if ok1 else d2))
                else:
                    ok1 = 1 <= q - c1 <= self.max_dist
                    ok2 = 1 <= q - c2 <= self.max_dist
                    cnd.append(c1 if ok1 else c2)
                ok.append(ok1 or ok2)
            startable = [act and o and q <= n - 12
                         for act, o, q in zip(active, ok, qs)]
            # each startable lane's agreement: the bytes a start there
            # would verify before its first mismatch, to the step's end
            agree = []
            for k in range(WARP):
                m = 0
                if startable[k]:
                    while m < WARP - k and self.byte(cnd[k] + m, q_end) \
                            == int(xp[qs[k] + m]):
                        m += 1
                agree.append(m)
            # a match must end at the first lane with q >= len - 5; lanes
            # from `stop` on are past the scan
            lim = next((k for k in range(WARP) if qs[k] >= n - 5), WARP)
            stop = min(WARP, q_end - base)
            lane = 0
            if mode == 1:                  # a match carried from the last step
                self.rounds += 1
                fail = [k for k in range(WARP) if active[k] and not (
                    self.byte(cand + qs[k] - a, q_end) == cur4[k] & 255
                    and qs[k] < n - 5 and qs[k] - a < MAX_MLEN + 3)]
                if not fail:
                    continue               # it runs into the next step
                f = fail[0]
                mlen = qs[f] - a
                if mlen >= 4:
                    dec[qs[f] >> 2] = ((a - cand) | ((qs[f] & 3) << 16)
                                       | ((mlen - 4) << 18))
                mode = 0
                lane = f + 1
            while True:
                self.rounds += 1
                s = [k for k in range(lane, WARP)
                     if startable[k] and agree[k]]
                if not s:
                    break
                k = s[0]
                e = min(k + agree[k], lim)
                if e >= stop:              # it runs past the step
                    cand, a, mode = cnd[k], qs[k], 1
                    break
                if e - k >= 4:
                    dec[qs[e] >> 2] = ((qs[k] - cnd[k]) | ((qs[e] & 3) << 16)
                                       | ((e - k - 4) << 18))
                lane = e + 1
        return dec


def find_matches_lockstep(inp: torch.Tensor, lens: torch.Tensor,
                          hist: torch.Tensor | None = None,
                          hlen: torch.Tensor | None = None, *,
                          max_dist: int = MAX_DIST,
                          hash_bits: int = HASH_BITS):
    """Decisions int32[B, n_rows] from the warp model (CPU tensors), and
    the models (one per block)."""
    _check(inp, lens, hist, hlen, hash_bits)
    B, row = inp.shape
    n_rows = row // 4
    x_np = inp.cpu().numpy()
    h_np = None if hist is None else hist.cpu().numpy()
    hl_l = [0] * B if hlen is None else hlen.cpu().tolist()
    out = np.zeros((B, n_rows), np.uint32)
    models = []
    for b, n in enumerate(lens.cpu().tolist()):
        m = WaveLockstepModel(x_np[b], n, None if h_np is None else h_np[b],
                              hl_l[b], max_dist, hash_bits)
        out[b] = m.run(n_rows)
        models.append(m)
    return torch.from_numpy(out.view(np.int32)), models


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _default_emitter():
    from lz4_tpu_torch.native import blockcodec
    return blockcodec.wave_emit_decisions


def find_matches_batch(blocks, *, max_dist: int = MAX_DIST,
                       hash_bits: int = HASH_BITS,
                       device=None) -> np.ndarray:
    """Match decisions for `blocks` in one launch: int32[B, n_rows], one
    row per block."""
    dev = resolve_device(device)
    inp, lens = pack_input(blocks, rows_for(max(len(b) for b in blocks)))
    dec = find_matches(torch.from_numpy(inp).to(dev),
                       torch.from_numpy(lens).to(dev), max_dist=max_dist,
                       hash_bits=hash_bits)
    return dec.cpu().numpy()


def encode_wave_batch(blocks, *, max_dist: int = MAX_DIST,
                      hash_bits: int = HASH_BITS, emitter=None,
                      device=None) -> list[bytes]:
    """Independent blocks: device match finding, then host emission (the
    C emitter unless another is given). Returns LZ4 block streams with
    offsets capped at max_dist."""
    if not blocks:
        return []
    emitter = emitter or _default_emitter()
    dec = find_matches_batch(blocks, max_dist=max_dist,
                             hash_bits=hash_bits, device=device)
    return emitter(list(blocks), dec)


def encode_wave_linked(streams: list[list[bytes]], *,
                       max_dist: int = MAX_DIST,
                       hash_bits: int = HASH_BITS, emitter=None,
                       device=None) -> list[list[bytes]]:
    """Linked streams: block t of each stream sees the tail of the
    stream's earlier bytes as history, so matches reach across block
    boundaries (prefix-dict semantics). One launch per round; the round's
    decision rows, and with them the history window, follow its longest
    block. Returns per-stream lists of LZ4 block streams."""
    emitter = emitter or _default_emitter()
    dev = resolve_device(device)
    rounds = max((len(s) for s in streams), default=0)
    outs: list[list[bytes]] = [[] for _ in streams]
    for t in range(rounds):
        blocks = [s[t] if t < len(s) else b"" for s in streams]
        n_rows = rows_for(max(len(b) for b in blocks))
        inp, lens = pack_input(blocks, n_rows)
        hist, hlen = pack_history(streams, t,
                                  history_rows(max_dist, n_rows))
        dec = find_matches(
            *(torch.from_numpy(a).to(dev) for a in (inp, lens, hist, hlen)),
            max_dist=max_dist, hash_bits=hash_bits).cpu().numpy()
        enc = emitter(blocks, dec)
        for j, s in enumerate(streams):
            if t < len(s):
                outs[j].append(enc[j])
    return outs


def emit_from_decisions(block: bytes, decisions: np.ndarray) -> bytes:
    """The emitter in Python (the oracle of the C one): decisions
    int32[n_rows] of ONE block -> standard LZ4 sequence bytes, with the
    host catch-up over preceding literals and the end-of-block
    re-checks."""
    n = len(block)
    out = bytearray()
    anchor = 0
    seqs = []          # (lit_start, lit_len, off, mlen)
    for r in range(min(decisions.shape[0], (n + 3) >> 2)):
        d = int(decisions[r]) & 0xFFFFFFFF
        if not d:
            continue
        off = d & 0xFFFF
        mlen = (d >> 18) + 4
        q = 4 * r + ((d >> 16) & 3)
        a = q - mlen
        if a >= anchor and a <= n - 12 and q <= n - 5 and off >= 1:
            while a > anchor and a > off and block[a - 1] == \
                    block[a - 1 - off]:
                a -= 1
                mlen += 1
            seqs.append((anchor, a - anchor, off, mlen))
            anchor = q

    def ext(le):
        le -= 15
        while le >= 255:
            out.append(255)
            le -= 255
        out.append(le)

    for (ls, ll, off, mlen) in seqs:
        ml = mlen - 4
        out.append((min(ll, 15) << 4) | min(ml, 15))
        if ll >= 15:
            ext(ll)
        out += block[ls: ls + ll]
        out.append(off & 255)
        out.append(off >> 8)
        if ml >= 15:
            ext(ml)
    ll = n - anchor
    out.append(min(ll, 15) << 4)
    if ll >= 15:
        ext(ll)
    out += block[anchor:]
    return bytes(out)
