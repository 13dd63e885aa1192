"""Batched block decode: kernel B2 (`csrc/decode_serial.cu`) and its
plain PyTorch version.

Contract of `lz4_tpu.block.decode_pallas.decode_blocks_pallas`:
comp uint8[B, cap_in], comp_lens int32[B], optionally dict_bufs
uint8[B, 65536] (right-aligned history) with dict_lens int32[B] ->
(out uint8[B, cap_out], olen int32[B], err int32[B]). Where err[b] is 0,
out[b, :olen[b]] is the decoded block; bytes past olen, and the whole
row where err[b] is 1, are unspecified. Bytes at or past cap_in read as
0. `loose` drops the two end-of-block MFLIMIT rules (for pieces of a
split block).
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import DICT_CAP, result_rows, to_device_batch
from lz4_tpu_torch.constants import MINMATCH

#: kernel launches made by `decode_blocks` (and nowhere else)
launches = 0
WARP = 32


def decode_blocks(comp, comp_lens, dict_bufs=None, dict_lens=None, *,
                  cap_out: int, loose: bool = False):
    """Decode a batch of LZ4 blocks (see the module docstring).

    Tensors stay on their device: CPU tensors run the plain version, CUDA
    tensors launch B2. numpy arrays go to the GPU (raising where there is
    none).
    """
    global launches
    if cap_out < 0:
        raise ValueError(f"cap_out must be >= 0, got {cap_out}")
    device = comp.device if isinstance(comp, torch.Tensor) else None
    comp, comp_lens, dict_bufs, dict_lens = to_device_batch(
        comp, comp_lens, dict_bufs, dict_lens, device=device)
    B, cap_in = comp.shape
    if comp.is_cuda and (cap_out + DICT_CAP >= 1 << 31 or cap_in >= 1 << 30):
        raise ValueError(f"B2 indexes in 32 bits: cap_out {cap_out} + 65536 "
                         f"must be < 2^31 and cap_in {cap_in} < 2^30")
    outs = result_rows(B, cap_out, comp.device)
    res, n = _build.launch(
        "decode_serial", "B2", comp.device,
        lambda: decode_blocks_plain(comp, comp_lens, dict_bufs, dict_lens,
                                    cap_out=cap_out, loose=loose),
        outs, comp, comp_lens, dict_bufs, dict_lens, *outs, B, cap_in,
        cap_out, int(dict_bufs is not None), int(bool(loose)))
    launches += n
    return res


# --------------------------------------------------------------------------
# plain version: the same serial parse and checks, in Python
# --------------------------------------------------------------------------

def _decode_one(row: bytes, M: int, hist: bytes, low: int, cap_out: int,
                loose: bool):
    """One block. Returns (decoded bytes incl. the history prefix, olen,
    err)."""
    d0 = len(hist)
    cap_in = len(row)
    ow = d0 + cap_out
    ob = bytearray(hist)

    def cb(q):
        return row[q] if q < cap_in else 0

    p, o = 0, d0
    err = done = M < 0
    while p < M and not err and not done:
        tok = cb(p)
        matnib = tok & 15
        litlen = tok >> 4
        q = p + 1
        if litlen == 15:
            while True:
                v = cb(q)
                q += 1
                litlen += v
                if v != 255:
                    break
        lit_start = q
        lit_end = lit_start + litlen
        is_last = lit_end >= M
        offset = mext = 0
        next_p = lit_end + 2
        if not is_last:
            offset = cb(lit_end) | (cb(lit_end + 1) << 8)
            if matnib == 15:
                while True:
                    v = cb(next_p)
                    next_p += 1
                    mext += v
                    if v != 255:
                        break
        mlen = MINMATCH + matnib + mext

        serr = (is_last and lit_end != M) or o + litlen > ow
        if not serr:
            lits = row[lit_start: lit_end]
            ob += lits + bytes(litlen - len(lits))   # past cap_in reads 0
        o_mid = o + litlen
        if not is_last:
            serr = (serr or next_p > M or offset == 0
                    or (not loose and lit_end > M - 8))
        do_match = not is_last and not serr
        if do_match:
            serr = (o_mid - offset < low or o_mid + mlen > ow
                    or (not loose and o_mid > ow - 12))
            do_match = not serr
        if do_match:
            base = o_mid - offset
            if offset >= mlen:
                ob += ob[base: base + mlen]
            else:       # overlapping: repeat the offset-long period
                period = ob[base: o_mid]
                ob += (period * (-(-mlen // offset)))[:mlen]
        o = o_mid + mlen if do_match else (o if serr else o_mid)
        done = is_last or serr
        err = serr
        p = next_p
    err = err or not done                 # truncated or endless stream
    return ob, (0 if err else o - d0), int(err)


def decode_blocks_plain(comp, comp_lens, dict_bufs=None, dict_lens=None, *,
                        cap_out: int, loose: bool = False):
    """Plain PyTorch version of B2 on CPU tensors: the kernel's parse and
    checks in Python over each block's bytes, written into tensors of the
    kernel's contract (rows that err are left zero)."""
    B = comp.shape[0]
    out = torch.zeros((B, cap_out), dtype=torch.uint8)
    olen = torch.zeros(B, dtype=torch.int32)
    err = torch.zeros(B, dtype=torch.int32)
    comp_np = comp.cpu().numpy()
    lens_l = comp_lens.cpu().tolist()
    has_dict = dict_bufs is not None
    if has_dict:
        dict_np = dict_bufs.cpu().numpy()
        dlens_l = dict_lens.cpu().tolist()
    for b in range(B):
        if has_dict:
            hist = dict_np[b].tobytes()
            low = DICT_CAP - min(dlens_l[b], DICT_CAP)
        else:
            hist, low = b"", 0
        ob, n, e = _decode_one(comp_np[b].tobytes(), lens_l[b], hist, low,
                               cap_out, loose)
        if not e and n:
            out[b, :n] = torch.frombuffer(ob, dtype=torch.uint8)[
                len(hist): len(hist) + n]
        olen[b] = n
        err[b] = e
    return out, olen, err


# --------------------------------------------------------------------------
# CPU model of the kernel's order
# --------------------------------------------------------------------------

def parse_sequences(row: bytes, M: int, d0: int, low: int, cap_out: int,
                    loose: bool):
    """B2's parse warp on one block: yields a descriptor (lit_src,
    out_mid, litlen, mlen, offset; output positions relative to the row,
    mlen 0 for the last sequence) for every sequence that passes the
    checks, in stream order, and returns (olen, err). A failing sequence
    is never yielded: the first one in stream order decides err.

    As in the kernel: each of 32 lanes holds the records of the sequences
    that would start at base + lane and base + 32 + lane (literal start
    and length, match length, offset, next token; None for the last),
    built from the bytes alone and rebuilt when a hop leaves them; a hop
    takes only the next token; every 32 hops (or at the end) the batch is
    checked at once, each sequence at its output start from a prefix sum
    of the sizes before it, and the first failing one ends the stream."""
    cap_in = len(row)
    ow = d0 + cap_out

    def cb(q):
        return row[q] if q < cap_in else 0

    def record(q0):
        matnib, litlen, q = cb(q0) & 15, cb(q0) >> 4, q0 + 1
        if litlen == 15:
            while True:
                v = cb(q)
                q += 1
                litlen += v
                if v != 255:
                    break
        mlen, offset, nxt = MINMATCH + matnib, 0, None
        if q + litlen < M:          # not the last sequence
            offset = cb(q + litlen) | (cb(q + litlen + 1) << 8)
            nxt = q + litlen + 2
            if matnib == 15:
                while True:
                    v = cb(nxt)
                    nxt += 1
                    mlen += v
                    if v != 255:
                        break
        return q, litlen, mlen, offset, nxt

    if M <= 0:
        return 0, 1
    o, p, base, recs = d0, 0, None, None
    while True:
        hops = []
        while len(hops) < WARP and p is not None and p < M:
            if base is None or p - base >= 2 * WARP:
                base = p
                recs = [record(p + j) for j in range(2 * WARP)]
            hops.append(recs[p - base])
            p = hops[-1][4]
        fail, o_k = len(hops), o
        for k, (q, litlen, mlen, offset, nxt) in enumerate(hops):
            lit_end = q + litlen
            is_last = nxt is None
            serr = (is_last and lit_end != M) or litlen > ow - o_k
            o_mid = o_k if serr else o_k + litlen
            if not is_last:
                serr = (serr or nxt > M or offset == 0
                        or (not loose and lit_end > M - 8))
            if not is_last and not serr:
                serr = (o_mid - offset < low or mlen > ow - o_mid
                        or (not loose and o_mid > ow - 12))
            if serr:
                fail = k
                break
            yield q, o_mid - d0, litlen, 0 if is_last else mlen, offset
            o_k = o_mid + (0 if is_last else mlen)
            if is_last:
                return o_k - d0, 0
        if fail < len(hops) or p is None or p >= M:
            return 0, 1             # a failing sequence, or no last one
        o = o_k


class DecodeParallelModel:
    """What one CTA of B2 does with one block, actor by actor: the parse
    warp's descriptors (`parse_sequences`) go into a ring of `ring` slots
    (each slot reused only after the copy warp that owns its last
    descriptor has read it), `head` released with the output end of the
    last descriptor after every `batch` descriptors, before the parser
    waits on a full ring, and at the end; `copy_warps` copy warps take
    descriptors c, c+C, ... in turn. Each copy warp publishes `pos`,
    below which all of its own sequences are done: the start of the
    sequence it has taken, its end once copied, or, while its next
    descriptor is unpublished, the output end of the last one published
    (`obound`, read with `head` as one pair). A literal run copies at
    once; a match waits until min(pos) covers the source bytes that other
    warps own (`wait` False drops that wait, for tests). A seeded
    scheduler runs one actor step at a time in a random order. Every
    write asserts that it lies inside the row, every match source that it
    lies at or after the history's first byte, every output read that its
    byte is final, and every ring read that its slot still holds the
    descriptor it wants."""

    def __init__(self, copy_warps: int = 4, ring: int = 256, seed: int = 0,
                 wait: bool = True, batch: int = 32):
        self.C = copy_warps
        self.R = ring
        self.rng = np.random.default_rng(seed)
        self.wait = wait
        self.batch = batch
        self.waits = 0               # scheduler steps spent waiting on pos

    def _run(self, actors):
        actors = list(actors)
        while actors:
            a = actors[int(self.rng.integers(len(actors)))]
            try:
                next(a)
            except StopIteration:
                actors.remove(a)

    def decode(self, row: bytes, M: int, hist: bytes, low: int,
               cap_out: int, loose: bool):
        """One block, as `_decode_one`'s arguments. Returns (out bytearray
        of cap_out, olen, err)."""
        C, R = self.C, self.R
        d0 = len(hist)
        cap_in = len(row)
        T = bytearray(cap_out)
        final = bytearray(cap_out)
        ring = [None] * R
        st = {"head": 0, "obound": 0, "total": None, "res": None}
        taken = list(range(C))
        pos = [0] * C

        def parser():
            gen = parse_sequences(row, M, d0, low, cap_out, loose)
            i = freed = oend = 0

            def flush():            # one store of the pair in the kernel
                st["head"], st["obound"] = i, oend

            while True:
                try:
                    d = next(gen)
                except StopIteration as stop:
                    st["res"] = stop.value
                    break
                if i >= freed + R:
                    flush()
                while i >= freed + R:
                    freed = min(taken)
                    yield
                ring[i % R] = (i, d)
                oend = d[1] + d[3]
                i += 1
                if i % self.batch == 0:
                    flush()
                yield
            flush()
            st["total"] = i

        def read(x):
            if x < 0:
                assert x >= low - d0, "match source before the history"
                return hist[d0 + x]
            assert final[x], f"read of byte {x} before it is final"
            return T[x]

        def write(x, v):
            assert 0 <= x < cap_out, f"write at {x} outside the row"
            T[x] = v
            final[x] = 1

        def copier(c):
            i, fp, mypos = c, 0, 0
            while True:
                while True:
                    head, ob = st["head"], st["obound"]
                    if head > i:
                        break
                    if ob > mypos:
                        mypos = pos[c] = ob
                    if st["total"] is not None and i >= st["total"]:
                        pos[c] = 1 << 62
                        return
                    yield
                j, (lit_src, out_mid, litlen, mlen, off) = ring[i % R]
                assert j == i, "ring slot overwritten before it was read"
                o0 = out_mid - litlen
                taken[c] = i + C
                mypos = pos[c] = max(mypos, o0)
                yield
                for k in range(litlen):
                    q = lit_src + k
                    write(o0 + k, row[q] if q < cap_in else 0)
                yield
                if mlen:
                    base = out_mid - off
                    need = min(base + mlen, o0)
                    while self.wait and need > fp:
                        fp = min(pos)
                        if fp < need:
                            self.waits += 1
                            yield
                    for k in range(mlen):
                        write(out_mid + k,
                              read(base + (k % off if off < mlen else k)))
                mypos = pos[c] = out_mid + mlen
                i += C
                yield

        self._run([parser()] + [copier(c) for c in range(C)])
        olen, err = st["res"]
        if not err:
            assert all(final[:olen]), "an output byte was never written"
        return T, olen, err


def decode_blocks_model(comp, comp_lens, dict_bufs=None, dict_lens=None, *,
                        cap_out: int, loose: bool = False, copy_warps=4,
                        ring=256, seed=0, batch=32):
    """`decode_blocks_plain`'s contract computed by `DecodeParallelModel`
    (rows that err are left zero)."""
    B = comp.shape[0]
    out = torch.zeros((B, cap_out), dtype=torch.uint8)
    olen = torch.zeros(B, dtype=torch.int32)
    err = torch.zeros(B, dtype=torch.int32)
    comp_np = comp.cpu().numpy()
    lens_l = comp_lens.cpu().tolist()
    for b in range(B):
        if dict_bufs is not None:
            hist = dict_bufs[b].cpu().numpy().tobytes()
            low = DICT_CAP - min(int(dict_lens[b]), DICT_CAP)
        else:
            hist, low = b"", 0
        model = DecodeParallelModel(copy_warps, ring, seed + b, batch=batch)
        T, n, e = model.decode(comp_np[b].tobytes(), lens_l[b], hist, low,
                               cap_out, loose)
        if not e and n:
            out[b, :n] = torch.frombuffer(T, dtype=torch.uint8)[:n]
        olen[b] = n
        err[b] = e
    return out, olen, err
