"""The sort/scan block decoder as torch ops: the port's counterpart of
`lz4_tpu.block.decode_jax` (`decode_blocks`, `decode_blocks_host`), which
the JAX package runs outside any Pallas kernel. `TorchBackend` runs it for
decodes of 256 KB or less when `serial_decode` is off, and `ShardedCodec`
decodes with it.

The stages are the JAX module's, over a batch dimension written out in
place of `vmap`, on the tensors' own device, with the same error flags
(the sound-subset contract that kernel B2 mirrors):

1. the token parse: every stream position is parsed as if a sequence
   started there (token, 255-chained length extensions read through the
   JAX module's next-non-255 table, offset), giving that sequence's
   records, its checks and its successor; the sequences of the stream are
   the positions reachable from 0, marked by pointer doubling over the
   successor table in log2 of the token bound rounds. The JAX module
   walks the stream one sequence a step in a `lax.scan`; the records and
   flags are the same.
2. placement by cumsum over the sequences, and the bounds, window and
   offset checks as reductions;
3. each output byte finds its sequence by `searchsorted` over the
   sequences' output starts, and its literal byte by one gather from the
   stream. The JAX module routes both with merge-by-sort passes and a
   fill scan (`sort_gather`), which stand in for gathers that the TPU
   serializes; the outputs are the same.
4. match resolution: a match byte points at its source (a whole token
   back, through the JAX module's analytic escape for overlapping
   copies), a literal or history byte is a terminal, and ptr <- X[ptr]
   doubles the resolved depth a round until no pointer is left (checked
   by `.any()` each round, as the JAX `while_loop` does), at most
   max(19, log2(cap_out) + 2) rounds.

Contract (the JAX function's): comp uint8[B, cap_in] (cap_in < 8 MB),
comp_lens int32[B] (each <= cap_in), dict_bufs uint8[B, 65536]
right-aligned history with dict_lens int32[B] (used when `has_dict`),
out_caps int32[B] the callers' capacities (default cap_out) -> (out
uint8[B, cap_out], out_lens int32[B], errs int32[B]). `partial` gives
LZ4_decompress_safe_partial semantics. The TPU tuning switches of the
JAX module (`COMP_ROUNDS`, `CHASE_SORT_ROUNDS`, `CHASE_RANK`,
`CHASE_RMAX_OVERRIDE`) decode the same bytes by contract and are not
ported. Rows decode on their own, so the batch is cut into chunks of rows
that fit `BUDGET`.
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch.block.backend import BlockDecodeError
from lz4_tpu_torch.block.batch import (DICT_CAP, bucket_cap, pack_blocks,
                                       to_device_batch)
from lz4_tpu_torch.constants import LZ4_DISTANCE_MAX, MINMATCH

#: int64 work arrays live at a chunk's peak, per position (stream, output
#: and history), as `chip_smoke.py` measures them on the card
_LANES = 6
#: device memory one chunk of rows may take, by device type
BUDGET = {"cuda": 4 << 30, "cpu": 256 << 20}
_I32 = torch.int32


def _rcummin(a):
    """Reverse cumulative minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(a, [-1]), dim=-1).values, [-1])


def _take(a, idx):
    """a[r, idx[r, j]] (idx of any integer type)."""
    return a.gather(1, idx.long())


def parse_tokens(comp, comp_lens, *, cap_out: int, partial: bool):
    """Stage 1 (decode_jax.py:127-274) for comp uint8[R, cap_in]: per
    stream position, the records of its sequence if the stream's parse
    reaches it, else 0: (lit_starts, litlens, offs, mlens) int32[R,
    cap_in], plus err and seen_last bool[R] of the walk."""
    R, cap_in = comp.shape
    dev = comp.device
    SH = max(17, int(cap_in).bit_length())
    mask = (1 << SH) - 1
    idx = torch.arange(cap_in, dtype=_I32, device=dev)
    c = comp.to(_I32)
    M = comp_lens.to(_I32)[:, None]

    # nn[i]: next non-255 byte position at or after i; vnn[i]: its byte
    nn = _rcummin(torch.where(c != 255, idx, cap_in))
    vnn = torch.where(nn < cap_in, _take(c, nn.clamp(max=cap_in - 1)), 0)
    A = nn | (vnn << SH)
    pad = torch.full((R, 2), cap_in, dtype=_I32, device=dev)
    A_ext = torch.cat([A, pad], dim=1)                  # [R, cap_in + 2]
    W = c | (torch.cat([c[:, 1:], torch.zeros((R, 1), dtype=_I32,
                                              device=dev)], dim=1) << 8)

    # the sequence that would start at every position p
    p = idx.expand(R, cap_in)
    tok = c
    a1 = A_ext[:, 1: cap_in + 1]
    litnib = tok >> 4
    q = a1 & mask
    extlit = 255 * (q - (p + 1)) + (a1 >> SH)
    litlen = torch.where(litnib == 15, litnib + extlit, litnib)
    lit_start = torch.where(litnib == 15, q + 1, p + 1)
    if partial:
        litlen = torch.minimum(litlen, (M - lit_start).clamp(min=0))
    lit_end = lit_start + litlen
    is_last = lit_end >= M
    j = lit_end.clamp(0, cap_in - 1)
    w = _take(W, j)
    a2 = _take(A_ext, j + 2)
    offset = w & 0xFFFF
    matnib = tok & 15
    mo = lit_end + 2
    q2 = a2 & mask
    extmat = 255 * (q2 - mo) + (a2 >> SH)
    mlen = MINMATCH + torch.where(matnib == 15, matnib + extmat, matnib)
    next_p = torch.where(matnib == 15, q2 + 1, mo)
    if partial:
        bad = ~is_last & ((next_p > M) | (offset == 0))
    else:
        bad = torch.where(is_last, lit_end != M,
                          (next_p > M) | (offset == 0) | (lit_end > M - 8))
    done = p >= M
    good = ~done & ~bad

    # the walk from position 0: succ(p) is the next sequence, cap_in (a
    # sink) after a bad or last one; marks spread by pointer doubling
    sink = torch.full((R, 1), cap_in, dtype=torch.long, device=dev)
    jump = torch.cat([torch.where(good & ~is_last, next_p,
                                  cap_in).long(), sink], dim=1)
    mark = torch.zeros((R, cap_in + 1), dtype=torch.bool, device=dev)
    mark[:, 0] = True
    T = cap_in // 3 + 2          # every sequence but the last is >= 3 bytes
    for _ in range(T.bit_length()):             # 2^r > T hops
        mark.scatter_(1, torch.where(mark, jump, cap_in), True)
        jump = jump.gather(1, jump)
    visited = mark[:, :cap_in] & ~done
    ok = visited & good
    err = (visited & bad).any(dim=1) if not partial else \
        torch.zeros(R, dtype=torch.bool, device=dev)
    seen_last = (ok & is_last).any(dim=1)
    mid = ok & ~is_last
    z = torch.zeros((), dtype=_I32, device=dev)
    recs = (torch.where(ok, lit_start, z),
            torch.where(ok, litlen.clamp(max=cap_out + 1), z),
            torch.where(mid, offset, z),
            torch.where(mid, mlen.clamp(max=cap_out + 1), z))
    return recs, err, seen_last


def decode_rows(comp, comp_lens, dict_bufs, dict_lens, out_caps, *,
                cap_out: int, has_dict: bool, partial: bool):
    """One chunk of rows, all stages (decode_jax.py:282-623); no
    chunking, no checks."""
    R, cap_in = comp.shape
    dev = comp.device
    (lit_starts, litlens, offs, mlens), err, seen_last = parse_tokens(
        comp, comp_lens, cap_out=cap_out, partial=partial)
    dlen = dict_lens.to(_I32)[:, None] if has_dict else 0
    if not partial:
        err = err | ~seen_last          # truncated / endless stream

    # placement and checks, over the sequences in stream order
    contrib = litlens + mlens
    csum = torch.cumsum(contrib, dim=1, dtype=_I32)
    dst_start = csum - contrib
    total_out = csum[:, -1:]
    oc = out_caps.to(_I32)[:, None]
    match_dst = dst_start + litlens
    has_m = mlens > 0
    under = has_m & (match_dst - offs < -dlen)
    far = has_m & (offs > LZ4_DISTANCE_MAX)
    if partial:
        rel = has_m & (dst_start < oc)
        err = err | (rel & under).any(dim=1) | (rel & far).any(dim=1)
        total_out = torch.minimum(total_out, oc)
    else:
        # no match may begin within MFLIMIT of the caller's capacity
        err = (err | (csum > oc).any(dim=1) | under.any(dim=1)
               | far.any(dim=1) | (has_m & (match_dst > oc - 12)).any(dim=1))

    # each output byte's sequence: the last with its output start <= o
    # (a sequence of no output shares its start with the next one, which
    # sorts after it)
    o = torch.arange(cap_out, dtype=_I32, device=dev).expand(R, cap_out)
    s = (torch.searchsorted(dst_start.contiguous(), o.contiguous(),
                            right=True) - 1).clamp(min=0)
    p_start = dst_start.gather(1, s)
    p_ls = lit_starts.gather(1, s)
    # the 64 KB tier carries litlen in 16 bits (decode_jax.py:384-401)
    ll = litlens.clamp(0, 0xFFFF) if cap_out <= 65536 else litlens
    ll_m = ll.gather(1, s)
    offcode = torch.where(has_m, offs.clamp(min=1) - 1, 0xFFFF).gather(1, s)
    del s
    t = o - p_start
    covered = o < total_out
    is_lit = covered & ((t < ll_m) | (offcode == 0xFFFF))
    is_mat = covered & ~is_lit
    # a match byte's source a whole token back: an overlapping copy's
    # chain inside its own token is an arithmetic progression
    d_off = offcode + 1
    k_in = torch.div((t - ll_m).clamp(min=0), d_off,
                     rounding_mode="floor") + 1
    src_out = o - k_in * d_off
    if has_dict:
        dict_ptr = cap_out + (DICT_CAP + src_out).clamp(0, DICT_CAP - 1)
        mat_ptr = torch.where(src_out >= 0, src_out, dict_ptr)
        dom = cap_out + DICT_CAP
    else:
        err = err | (is_mat & (src_out < 0)).any(dim=1)
        mat_ptr = src_out.clamp(0, cap_out - 1)
        dom = cap_out
    mat_ptr = mat_ptr.clamp(0, dom - 1)
    # literal source cursor: non-decreasing in output order
    qsrc = torch.cummax(torch.where(is_lit, (p_ls + t).clamp(0, cap_in - 1),
                                    0), dim=1).values
    lit_byte = _take(comp, qsrc).to(_I32)
    # literals (and history bytes) enter resolved as -(byte + 1)
    ptr = torch.where(is_lit, -lit_byte - 1,
                      torch.where(covered, mat_ptr, -1)).long()
    del t, is_lit, is_mat, k_in, src_out, mat_ptr, qsrc, lit_byte
    terms = (-dict_bufs.long() - 1) if has_dict else None

    rmax = max(19, int(cap_out).bit_length() + 2)
    for _ in range(rmax):
        live = ptr >= 0
        if not bool(live.any()):
            break
        x = ptr if terms is None else torch.cat([ptr, terms], dim=1)
        ptr = torch.where(live, x.gather(1, ptr.clamp(0, dom - 1)), ptr)
    # a pointer left after the round bound: flag, never emit garbage
    err = err | (ptr >= 0).any(dim=1)
    out = torch.where(o < total_out, (-ptr - 1).to(torch.uint8),
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return out, total_out[:, 0], err.to(_I32)


def chunk_rows(cap_in: int, cap_out: int, device: torch.device) -> int:
    """Rows that one chunk may hold on `device`."""
    per_row = (cap_in + cap_out + DICT_CAP) * 8 * _LANES
    return max(1, BUDGET.get(device.type, BUDGET["cpu"]) // per_row)


def decode_blocks(comp, comp_lens, dict_bufs=None, dict_lens=None,
                  out_caps=None, *, cap_out: int, has_dict: bool,
                  partial: bool = False):
    """Batched block decode (see the module docstring). CPU and CUDA
    tensors alike stay on their device; numpy arrays go to the GPU."""
    if comp.shape[1] >= 1 << 23:
        # the parse table packs position | byte << SH with SH <= 23
        raise NotImplementedError("decode graph supports cap_in < 8 MB")
    if has_dict and dict_bufs is None:
        raise ValueError("has_dict needs dict_bufs and dict_lens")
    device = comp.device if isinstance(comp, torch.Tensor) else None
    comp, comp_lens, dict_bufs, dict_lens = to_device_batch(
        comp, comp_lens, dict_bufs if has_dict else None,
        dict_lens if has_dict else None, device=device)
    B, cap_in = comp.shape
    if out_caps is None:
        out_caps = torch.full((B,), cap_out, dtype=_I32, device=comp.device)
    else:
        out_caps = to_device_batch(comp, out_caps, device=comp.device)[1]
    step = chunk_rows(cap_in, cap_out, comp.device)
    outs, lens, errs = [], [], []
    for i in range(0, B, step):
        sl = slice(i, i + step)
        o, n, e = decode_rows(
            comp[sl], comp_lens[sl], dict_bufs[sl] if has_dict else None,
            dict_lens[sl] if has_dict else None, out_caps[sl],
            cap_out=cap_out, has_dict=has_dict, partial=partial)
        outs.append(o)
        lens.append(n)
        errs.append(e)
    if not outs:
        return (torch.zeros((0, cap_out), dtype=torch.uint8,
                            device=comp.device),
                torch.zeros(0, dtype=_I32, device=comp.device),
                torch.zeros(0, dtype=_I32, device=comp.device))
    return torch.cat(outs), torch.cat(lens), torch.cat(errs)


def decode_blocks_host(blocks, max_outs, dict_prefixes=None, *,
                       partial=False, device=None):
    """Decode a list of compressed blocks (bytes) in one batch on
    `device` (the GPU when None) with per-block capacities `max_outs`;
    returns list[bytes] and raises BlockDecodeError on any error flag
    (decode_jax.py:661-712)."""
    if not blocks:
        return []
    cap_in = bucket_cap(max(16, max(len(b) for b in blocks)))
    cap_out = bucket_cap(max(16, max(max_outs)))
    has_dict = dict_prefixes is not None and any(d for d in dict_prefixes)
    comp, lens, dict_bufs, dict_lens = pack_blocks(
        blocks, dict_prefixes, cap=cap_in, with_dict=True)
    out, out_lens, errs = decode_blocks(
        *to_device_batch(comp, lens, dict_bufs, dict_lens, device=device),
        np.asarray(max_outs, np.int32), cap_out=cap_out, has_dict=has_dict,
        partial=partial)
    out = out.cpu().numpy()
    out_lens = out_lens.cpu().tolist()
    errs = errs.cpu().tolist()
    results = []
    for i in range(len(blocks)):
        if errs[i]:
            raise BlockDecodeError(f"malformed block {i}")
        if out_lens[i] > max_outs[i]:
            raise BlockDecodeError(
                f"block {i} decodes to {out_lens[i]} > cap {max_outs[i]}")
        results.append(out[i, : out_lens[i]].tobytes())
    return results
