"""The sort/scan block encoder as torch ops: the port's counterpart of
`lz4_tpu.block.encode_jax` (`encode_blocks`), which the JAX package runs
outside any Pallas kernel and uses for level 2 (`n_cand=8`, `lazy=True`)
and for its dict/segmented fast tier.

The stages are the JAX module's, over a batch dimension written out in
place of `vmap`, on the tensors' own device:

1. candidate discovery: one stable sort of each row's 4-grams (with the
   forward and, on the lazy graph, backward context words gathered by
   the sort's indices); the nearest previous occurrences are the rows
   1..n_cand back in sorted order; extensions are byte compares of the
   carried words;
2. position order restored by a scatter, chain runs by a reverse cummin,
   lazy demotion, and the parse tables (next match position and its
   length) by a reverse cummin and a gather;
3. the greedy token hops (`_parse_hops`), by pointer doubling over the
   successor table: the same token list as one gather per hop
   (`_parse_hops_loop`, the JAX module's walk, kept for the tests), in
   about log2(cap_n) rounds instead of one launch per token;
4. the token merge (segmented sums as cumsums and gathers) and the
   sequence fields;
5. emission: each output byte finds its sequence by `searchsorted` over
   the sequences' output starts and is computed elementwise; literals are
   gathered from the row. The JAX module does this with merge-by-sort
   passes; the bytes are the same.

Contract (the JAX function's): src uint8[B, cap_n], lens int32[B],
dict_bufs uint8[B, 65536] right-aligned history with dict_lens int32[B]
(used when `has_dict`) -> (out uint8[B, compress_bound(cap_n)], csizes
int32[B], trailing int32[B]); out[b, :csizes[b]] is block b's LZ4 stream,
zero past it. cap_n above 65536 raises. Rows are encoded on their own, so
the batch is cut into chunks of rows that fit `BUDGET`.
"""
from __future__ import annotations

import torch

from lz4_tpu_torch.block.batch import (DICT_CAP, bucket_cap, pack_blocks,
                                       to_device_batch)
from lz4_tpu_torch.constants import (LASTLITERALS, LZ4_DISTANCE_MAX,
                                     MFLIMIT, MINMATCH, compress_bound)

#: carried forward-context words in the match sort (encode_jax.py:70)
ENC_NW = 5
#: carry the back-extension words on the greedy graphs too
#: (encode_jax.py:80); the lazy graph always carries them
ENC_BK = False
#: int64 work arrays live at a chunk's peak, per position, as
#: `chip_smoke.py` measures them on the card; it holds a chunk to `BUDGET`
_LANES = 28
#: device memory one chunk of rows may take, by device type
BUDGET = {"cuda": 4 << 30, "cpu": 256 << 20}


def _shl(a, k, fill):
    """a shifted toward lower indices along the last axis: out[i] = a[i+k]."""
    if k == 0:
        return a
    pad = torch.full((*a.shape[:-1], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[..., k:], pad], dim=-1)


def _shr(a, k, fill):
    """a shifted toward higher indices along the last axis: out[i] = a[i-k]."""
    if k == 0:
        return a
    pad = torch.full((*a.shape[:-1], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[..., :-k]], dim=-1)


def _rcummin(a):
    """Reverse cumulative minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(a, [-1]), dim=-1).values, [-1])


def _low_zero_bytes(x):
    """Matching low bytes (0..3) of a 32-bit XOR value x != 0."""
    return (((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long()
            + ((x & 0xFFFFFF) == 0).long())


def _high_zero_bytes(x):
    """Matching high bytes (0..4) of a 32-bit XOR value."""
    return (((x & 0xFF000000) == 0).long() + ((x & 0xFFFF0000) == 0).long()
            + ((x & 0xFFFFFF00) == 0).long() + (x == 0).long())


def _ext_count(v):
    return torch.where(v < 15, 0, 1 + torch.div(v - 15, 255,
                                                rounding_mode="floor"))


def _match_tables(buf, n, dlen, *, d0, n_cand, lazy, lite):
    """Stages 1-2 (encode_jax.py:120-280) for rows buf int64[R, N]:
    returns (nm_ext, nm_ml_ext, ml_ext, bk_ext, off_ext), each [R, N+1],
    the last column the "no match" sentinel (N, 0, 0, 0, 0)."""
    R, N = buf.shape
    dev = buf.device
    lo = (d0 - dlen)[:, None]            # first valid history byte
    end = (d0 + n)[:, None]              # one past the last source byte
    idx = torch.arange(N, device=dev)

    NW = 2 if lite else ENC_NW
    w = (buf | (_shl(buf, 1, 0) << 8) | (_shl(buf, 2, 0) << 16)
         | (_shl(buf, 3, 0) << 24))
    sk, spos = torch.sort(w, dim=-1, stable=True)
    sfwd = [_shl(w, 4 * (j + 1), 0).gather(-1, spos) for j in range(NW)]
    back = not (lite or not (lazy or ENC_BK))
    if back:
        swb = _shr(w, 4, 0).gather(-1, spos)     # gram at p-4
        swb2 = _shr(w, 8, 0).gather(-1, spos)    # gram at p-8
    del w

    def neighbour_fields(i):
        same = torch.cat([torch.zeros((R, i), dtype=torch.bool, device=dev),
                          sk[:, i:] == sk[:, :-i]], dim=-1)
        cand = _shr(spos, i, 0)
        ext = torch.zeros_like(cand)
        ok = same
        for sw in sfwd:
            x = sw ^ _shr(sw, i, 0)
            z = x == 0
            ext = torch.where(ok, ext + torch.where(z, 4, _low_zero_bytes(x)),
                              ext)
            ok = ok & z
        if back:
            xb = swb ^ _shr(swb, i, 0)
            xb2 = swb2 ^ _shr(swb2, i, 0)
            bk = torch.where(xb == 0, 4 + _high_zero_bytes(xb2),
                             _high_zero_bytes(xb))
            # the words are zero-filled before the buffer start: cap the
            # back bytes by what the candidate really has (:196-204)
            bk = torch.minimum(bk, torch.where(
                cand >= 8, 8, torch.where(cand >= 4, 4, 0)))
        else:
            bk = torch.zeros_like(cand)
        dist = spos - cand
        ok = same & (cand >= lo) & (dist >= 1) & (dist <= LZ4_DISTANCE_MAX)
        return torch.where(ok, cand, -1), ext, bk

    cand_s, ext_s, bk_s = neighbour_fields(1)
    for i in range(2, n_cand + 1):
        cand_j, ext_j, bk_j = neighbour_fields(i)
        better = (cand_j >= 0) & ((cand_s < 0) | (ext_j > ext_s))
        cand_s = torch.where(better, cand_j, cand_s)
        ext_s = torch.where(better, ext_j, ext_s)
        bk_s = torch.where(better, bk_j, bk_s)
    del sk, sfwd
    # back to position order: spos is a permutation of each row
    pack = (cand_s + 1) | (ext_s << 18) | (bk_s << 23)
    pk = torch.empty_like(pack).scatter_(-1, spos, pack)
    del pack, cand_s, ext_s, bk_s, spos
    cand = (pk & ((1 << 18) - 1)) - 1
    ext = (pk >> 18) & 31
    bk4 = pk >> 23
    del pk

    valid = cand >= 0
    ch = valid & (idx + 1 <= end - 4) & (_shl(cand, 1, -1) == cand + 1)
    nc = _rcummin(torch.where(ch, N, idx))
    ml = torch.where(valid, torch.maximum(nc - idx + MINMATCH,
                                          MINMATCH + ext), 0)
    ml = torch.minimum(ml, end - LASTLITERALS - idx)
    is_match = (valid & (idx >= d0) & (idx <= end - MFLIMIT)
                & (ml >= MINMATCH))
    if lazy:
        # demote a match when the next position holds a longer one
        demote = is_match & _shl(is_match, 1, False) & (_shl(ml, 1, 0) > ml)
        is_match = is_match & ~demote

    nm = _rcummin(torch.where(is_match, idx, N))
    nm_ml = torch.where(nm < N, ml.gather(-1, nm.clamp(max=N - 1)), 0)
    off = torch.where(valid, idx - cand, 0)
    bk4 = torch.minimum(bk4, (cand - lo).clamp(min=0)).clamp(max=8)

    def ext1(a, fill):
        return torch.cat([a, torch.full((R, 1), fill, dtype=a.dtype,
                                        device=dev)], dim=-1)
    return (ext1(nm, N), ext1(nm_ml, 0), ext1(ml, 0), ext1(bk4, 0),
            ext1(off, 0))


def _hop_count(cap_n: int) -> int:
    """T: the most tokens a block can hold, plus the padding row."""
    return cap_n // MINMATCH + 2


def _parse_hops(nm_ext, nm_ml_ext, *, d0, cap_n):
    """Greedy token positions int64[R, T] (N after the last), by pointer
    doubling: succ(p) = nm_ext[min(p + ml(p), N)], succ(N) = N; the path
    from nm[d0] strictly increases, so after r rounds of S <- S | J(S),
    J <- J o J (2^r >= T) the marked positions in order are the tokens."""
    R, N1 = nm_ext.shape
    N = N1 - 1
    T = _hop_count(cap_n)
    jump = nm_ext.gather(-1, (torch.arange(N1, device=nm_ext.device)
                              + nm_ml_ext).clamp(max=N))
    mark = torch.zeros((R, N1), dtype=torch.bool, device=nm_ext.device)
    mark.scatter_(-1, nm_ext[:, d0: d0 + 1], True)
    for _ in range(T.bit_length()):          # 2^r >= T + 1 hops
        # unmarked positions send their mark to N, which stays unused
        mark.scatter_(-1, torch.where(mark, jump, N), True)
        jump = jump.gather(-1, jump)
    return _tokens_from_marks(mark[:, :N], N, T)


def _tokens_from_marks(mark, N, T):
    R = mark.shape[0]
    rank = torch.cumsum(mark.long(), dim=-1) - 1
    tok = torch.full((R, T + 1), N, dtype=torch.long, device=mark.device)
    pos = torch.arange(N, device=mark.device).expand(R, N)
    tok.scatter_(-1, torch.where(mark, rank, T).clamp(max=T), pos)
    return tok[:, :T].contiguous()


def _parse_hops_loop(nm_ext, nm_ml_ext, *, d0, cap_n, chunk=64):
    """The same token list one gather per hop (encode_jax.py:293-348),
    checking every `chunk` hops whether every row has reached N."""
    R, N1 = nm_ext.shape
    N = N1 - 1
    T = _hop_count(cap_n)
    tok = torch.full((R, T), N, dtype=torch.long, device=nm_ext.device)
    cur = nm_ext[:, d0].clone()
    step = nm_ml_ext[:, d0].clone()
    for k in range(T):
        tok[:, k] = cur
        nxt = (cur + step).clamp(max=N)[:, None]
        cur, step = nm_ext.gather(-1, nxt)[:, 0], nm_ml_ext.gather(-1, nxt)[:, 0]
        if k % chunk == chunk - 1 and not bool((cur < N).any()):
            break
    return tok


def _emit(buf, n, tokpos, ml_ext, bk_ext, off_ext, *, d0, cap_n):
    """Stages 4-5 (encode_jax.py:355-534): (out uint8[R, cap_out],
    csize int64[R], trailing int64[R])."""
    R, N = buf.shape
    dev = buf.device
    cap_out = compress_bound(cap_n)
    end = (d0 + n)[:, None]
    tmask = tokpos < N
    ml_t = ml_ext.gather(-1, tokpos)
    bk_t = bk_ext.gather(-1, tokpos)
    off_t = off_ext.gather(-1, tokpos)
    Tn = tokpos.shape[1]
    ti = torch.arange(Tn, device=dev).expand(R, Tn)

    # token merge: chains of contiguous equal-offset tokens fold into
    # their head with the summed length
    prev_end = _shr(torch.where(tmask, tokpos + ml_t, -1), 1, -1)
    cont = tmask & (prev_end == tokpos) & (_shr(off_t, 1, 0) == off_t)
    head = tmask & ~cont
    csum_ml = torch.cumsum(ml_t, dim=-1)
    last_head = torch.cummax(torch.where(head, ti, 0), dim=-1).values
    run = csum_ml - torch.cat([torch.zeros((R, 1), dtype=torch.long,
                                           device=dev), csum_ml], dim=-1
                              ).gather(-1, last_head)
    is_last = tmask & _shl(head | ~tmask, 1, True)
    nl = _rcummin(torch.where(is_last, ti, Tn))
    total = torch.where(nl < Tn, run.gather(-1, nl.clamp(max=Tn - 1)), 0)
    ml_t = torch.where(head, total, 0)
    tmask = head

    tok_end = torch.where(tmask, tokpos + ml_t, d0)
    anchor = torch.cummax(_shr(tok_end, 1, d0), dim=-1).values
    bk_eff = torch.minimum(bk_t, tokpos - anchor).clamp(min=0)
    L = torch.where(tmask, tokpos - bk_eff - anchor, 0)
    M4 = torch.where(tmask, ml_t + bk_eff - MINMATCH, 0)
    off = torch.where(tmask, off_t, 0)
    el = _ext_count(L)
    em = _ext_count(M4)
    seq_bytes = torch.where(tmask, 1 + el + L + 2 + em, 0)
    csum = torch.cumsum(seq_bytes, dim=-1)
    out_start = csum - seq_bytes
    total_seq = csum[:, -1:]
    fanchor = torch.maximum(tok_end.max(dim=-1, keepdim=True).values,
                            torch.full_like(total_seq, d0))
    FL = end - fanchor
    fel = _ext_count(FL)
    csize = total_seq + 1 + fel + FL

    # each output byte's sequence: the last with out_start <= o (rows
    # folded into a head carry the next head's start, so the last such
    # row is a head), or the final literal-only sequence past total_seq
    o = torch.arange(cap_out, device=dev).expand(R, cap_out)
    s = (torch.searchsorted(out_start, o.contiguous(), right=True) - 1
         ).clamp(min=0)
    fin = o >= total_seq

    def field(a, final):
        return torch.where(fin, final, a.gather(-1, s))
    zero = torch.zeros_like(total_seq)
    start_o = field(out_start, total_seq)
    L_o = field(L, FL)
    el_o = field(el, fel)
    off_o = field(off, zero)
    M4_o = field(M4, zero)
    base_o = field(torch.where(tmask, anchor, 0), fanchor)
    t = o - start_o
    nfull = (L_o - 15).clamp(min=0) // 255
    mfull = (M4_o - 15).clamp(min=0) // 255
    lit_end = 1 + el_o + L_o
    token = (L_o.clamp(max=15) << 4) | M4_o.clamp(max=15)
    litext = torch.where(t - 1 < nfull, 255, L_o - 15 - 255 * nfull)
    matext = torch.where(t - (3 + el_o + L_o) < mfull, 255,
                         M4_o - 15 - 255 * mfull)
    val = torch.where(
        t == 0, token,
        torch.where(t < 1 + el_o, litext,
                    torch.where(t == lit_end, off_o & 0xFF,
                                torch.where(t == lit_end + 1, off_o >> 8,
                                            matext)))) & 0xFF
    is_lit = (t >= 1 + el_o) & (t < lit_end)
    lit = buf.gather(-1, (base_o + t - 1 - el_o).clamp(0, N - 1))
    val = torch.where(is_lit, lit, val)
    out = torch.where(o < csize, val, 0).to(torch.uint8)
    return out, csize[:, 0], FL[:, 0]


def encode_rows(src, lens, dict_bufs, dict_lens, *, cap_n, has_dict,
                n_cand=2, lazy=False, lite=False):
    """One chunk of rows, all stages (no chunking, no checks)."""
    d0 = DICT_CAP if has_dict else 0
    buf = src.long()
    if has_dict:
        buf = torch.cat([dict_bufs.long(), buf], dim=-1)
    n = lens.long()
    dlen = dict_lens.long() if has_dict else torch.zeros_like(n)
    nm_ext, nm_ml_ext, ml_ext, bk_ext, off_ext = _match_tables(
        buf, n, dlen, d0=d0, n_cand=n_cand, lazy=lazy, lite=lite)
    tokpos = _parse_hops(nm_ext, nm_ml_ext, d0=d0, cap_n=cap_n)
    del nm_ext, nm_ml_ext
    out, csize, trailing = _emit(buf, n, tokpos, ml_ext, bk_ext, off_ext,
                                 d0=d0, cap_n=cap_n)
    return out, csize.int(), trailing.int()


def chunk_rows(N: int, device: torch.device) -> int:
    """Rows of N positions that one chunk may hold on `device`."""
    return max(1, BUDGET.get(device.type, BUDGET["cpu"]) // (N * 8 * _LANES))


def encode_blocks(src, lens, dict_bufs=None, dict_lens=None, *, cap_n: int,
                  has_dict: bool, n_cand: int = 2, lazy: bool = False,
                  lite: bool = False):
    """Batched block encode (see the module docstring). CPU and CUDA
    tensors alike stay on their device; numpy arrays go to the GPU."""
    if cap_n > 65536:
        raise NotImplementedError(
            "the sort/scan encoder takes the 64 KB tier only; larger "
            "blocks are segmented by the engine")
    if has_dict and dict_bufs is None:
        raise ValueError("has_dict needs dict_bufs and dict_lens")
    device = src.device if isinstance(src, torch.Tensor) else None
    src, lens, dict_bufs, dict_lens = to_device_batch(
        src, lens, dict_bufs if has_dict else None,
        dict_lens if has_dict else None, device=device)
    if src.shape[1] != cap_n:
        raise ValueError(f"src must be uint8[B, {cap_n}], got "
                         f"{tuple(src.shape)}")
    B = src.shape[0]
    N = cap_n + (DICT_CAP if has_dict else 0)
    step = chunk_rows(N, src.device)
    outs, sizes, trails = [], [], []
    for i in range(0, B, step):
        sl = slice(i, i + step)
        o, c, t = encode_rows(
            src[sl], lens[sl], dict_bufs[sl] if has_dict else None,
            dict_lens[sl] if has_dict else None, cap_n=cap_n,
            has_dict=has_dict, n_cand=n_cand, lazy=lazy, lite=lite)
        outs.append(o)
        sizes.append(c)
        trails.append(t)
    if not outs:
        cap_out = compress_bound(cap_n)
        return (torch.zeros((0, cap_out), dtype=torch.uint8,
                            device=src.device),
                torch.zeros(0, dtype=torch.int32, device=src.device),
                torch.zeros(0, dtype=torch.int32, device=src.device))
    return torch.cat(outs), torch.cat(sizes), torch.cat(trails)


def encode_blocks_host(blocks, dict_prefixes=None, *, n_cand=2, lazy=False,
                       lite=False, device=None):
    """Compress a list of raw blocks (bytes, at most 64 KB each) in one
    batch on `device` (the GPU when None); returns list[bytes], raw LZ4
    block streams, possibly longer than the input: the caller applies
    the stored-block fallback (encode_jax.py:585-616)."""
    if not blocks:
        return []
    cap_n = bucket_cap(max(len(b) for b in blocks))
    has_dict = dict_prefixes is not None and any(d for d in dict_prefixes)
    src, lens, dict_bufs, dict_lens = to_device_batch(*pack_blocks(
        blocks, dict_prefixes, cap=cap_n, with_dict=has_dict), device=device)
    out, csizes, _ = encode_blocks(src, lens, dict_bufs, dict_lens,
                                   cap_n=cap_n, has_dict=has_dict,
                                   n_cand=n_cand, lazy=lazy, lite=lite)
    out = out.cpu().numpy()
    csizes = csizes.cpu().tolist()
    return [out[i, : csizes[i]].tobytes() for i in range(len(blocks))]
