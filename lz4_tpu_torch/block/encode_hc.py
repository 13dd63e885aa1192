"""Batched HC block encode, levels 3-9: kernel B5 (`csrc/encode_hc.cu`)
and its plain PyTorch version.

Contract of `lz4_tpu.block.encode_hc_pallas.encode_blocks_hc_pallas`
without its 4-byte word packing: src uint8[B, cap_n], lens int32[B] ->
(out uint8[B, compress_bound(cap_n)], csizes int32[B], trailing int32[B]),
where out[b, :csizes[b]] is block b's LZ4 stream and trailing[b] the
length of its final literal run. Bytes of out past csizes are
unspecified. No dict mode, and the 64 KB tier only (cap_n <= 65536). A
length outside [0, cap_n] is clamped into it; bytes of a row past its
length are read as they are, and reads past the row read 0 (the JAX
wrapper's zero padding).

The parse is the reference's hash-chain tier: a 2^15-entry head table
and 16-bit previous-occurrence deltas, the wider-match search with its
can-beat filter and back-extension, the Search2/Search3 overlap
arbitration as a machine over three states, the repeat-pattern analysis
at depth > 128 (level 9), and `favor_dec_speed`, which drops candidates
closer than 8. Its streams equal the JAX kernel's byte for byte, and so
the port's C `compress_lazy` at the same depth.
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch.block.batch import to_device_batch
from lz4_tpu_torch.constants import LASTLITERALS, MFLIMIT, compress_bound

HASH_LOG = 15
HASH_MUL = 2654435761          # Knuth multiplier
WINDOW = 65535
OPTIMAL_ML = 18
MAX_CAP_N = 65536
#: search depth per level 0..12 (the reference's nbSearches ladder, the
#: JAX package's K_DEPTH)
K_DEPTH = (4, 4, 4, 4, 8, 16, 32, 64, 128, 256, 256, 256, 256)
_PAD = 512                     # zero bytes the plain version reads past a row
_M32 = 0xFFFFFFFF

#: kernel launches made by `encode_blocks_hc` (and nowhere else)
launches = 0


def depth_for(level: int) -> int:
    """Chain search depth of an HC level (clamped to 0..12)."""
    return K_DEPTH[min(max(int(level), 0), 12)]


def _check_cap(cap_n: int) -> None:
    if not 0 <= cap_n <= MAX_CAP_N:
        raise ValueError(f"cap_n must be in [0, {MAX_CAP_N}], got {cap_n}")


def encode_blocks_hc(src, lens, *, cap_n: int, level: int = 9,
                     favor_dec_speed: bool = False):
    """HC-encode a batch of blocks (see the module docstring).

    Tensors stay on their device: CPU tensors run the plain version, CUDA
    tensors launch B5. numpy arrays go to the GPU (raising where there is
    none).
    """
    global launches
    _check_cap(cap_n)
    device = src.device if isinstance(src, torch.Tensor) else None
    src, lens, _, _ = to_device_batch(src, lens, device=device)
    if src.shape[1] != cap_n:
        raise ValueError(f"src must be uint8[B, {cap_n}], got "
                         f"{tuple(src.shape)}")
    if src.device.type == "cpu":
        return encode_blocks_hc_plain(src, lens, cap_n=cap_n, level=level,
                                      favor_dec_speed=favor_dec_speed)
    if src.device.type != "cuda":
        raise ValueError(f"no B5 kernel for device {src.device}")
    B = src.shape[0]
    bound = compress_bound(cap_n)
    out = torch.empty((B, bound), dtype=torch.uint8, device=src.device)
    csizes = torch.empty(B, dtype=torch.int32, device=src.device)
    trailing = torch.empty(B, dtype=torch.int32, device=src.device)
    if B == 0:
        return out, csizes, trailing
    from lz4_tpu_torch import _build
    fn = _build.load("encode_hc")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), lens.data_ptr(), out.data_ptr(),
                csizes.data_ptr(), trailing.data_ptr(), B, cap_n, bound,
                depth_for(level), int(bool(favor_dec_speed)), stream)
    if rc != 0:
        raise RuntimeError(f"B5 encode_hc launch failed: CUDA error {rc}")
    launches += 1
    return out, csizes, trailing


# --------------------------------------------------------------------------
# plain version: the kernel's machine, step for step, in Python
# --------------------------------------------------------------------------

def _common_prefix(buf: bytes, q1: int, q2: int, maxn: int) -> int:
    """Bytes equal at buf[q1+i] == buf[q2+i], i < maxn."""
    c = 0
    while c < maxn:
        k = min(32, maxn - c)
        if buf[q1 + c: q1 + c + k] == buf[q2 + c: q2 + c + k]:
            c += k
            continue
        while buf[q1 + c] == buf[q2 + c]:
            c += 1
        return c
    return c


def _encode_hc_one(buf: bytes, n: int, depth: int, favor: bool):
    """One block: buf = [block row | >= _PAD zeros]. Returns (stream,
    final literal run)."""
    t = np.frombuffer(buf, np.uint8).astype(np.uint64)
    seq = t[:-3] | (t[1:-2] << 8) | (t[2:-1] << 16) | (t[3:] << 24)
    W = seq.tolist()                                 # read4 at every q
    H = (((seq * HASH_MUL) & _M32) >> (32 - HASH_LOG)).tolist()
    head = [-1] * (1 << HASH_LOG)                    # -1: no chain
    chain = [0] * MAX_CAP_N                          # 0 ends a chain
    mflimit = n - MFLIMIT
    matchlimit = n - LASTLITERALS
    pa = depth > 128                                 # pattern analysis
    out = bytearray()

    def insert_range(a, b):
        """Insert [a, b) in order; returns max(a, b). Re-inserting the
        current head keeps its chain link."""
        for q in range(a, b):
            h = H[q]
            e = head[h]
            if e != q:
                d = q - e if e >= 0 else 0
                chain[q] = d if 0 < d <= WINDOW else 0
            head[h] = q
        return max(a, b)

    def count_pat_fwd(q, pat, limit):
        p = q
        while p + 4 <= limit and W[p] == pat:
            p += 4
        x = pat
        for _ in range(3):
            if not (p < limit and buf[p] == (x & 255)):
                break
            p += 1
            x = (x >> 8) | ((x << 24) & _M32)
        return p - q

    def count_pat_rev(q, pat, low):
        p = q
        while p >= low + 4 and W[p - 4] == pat:
            p -= 4
        x = pat
        for _ in range(3):
            if not (p > low and buf[max(p - 1, 0)] == (x >> 24)):
                break
            p -= 1
            x = ((x << 8) & _M32) | (x >> 24)
        return q - p

    def lazy_search(pos, lowpos, lg, ni):
        """Widest match at pos that may back-extend to lowpos and beats
        lg; positions [ni, pos) are inserted first, pos is not. Returns
        (len, off, back, ni'); off == 0 means nothing beat lg."""
        ni = insert_range(ni, pos)
        pat = W[pos]
        c = head[H[pos]]
        lowest = max(pos - WINDOW, 0)
        lookback = pos - lowpos
        offb = backb = 0
        if c < 0 or not lowest <= c < pos:
            return lg, offb, backb, ni
        tries, rep, spl = depth, 0, 0
        while tries > 0:
            # score candidate c: the can-beat filter (addresses clamped at
            # 0), then forward and backward extension
            a1 = lowpos + lg - 1
            a2 = c - lookback + lg - 1
            if ((W[max(a1, 0)] & 0xFFFF) == (W[max(a2, 0)] & 0xFFFF)
                    and W[c] == pat and not (favor and pos - c < 8)):
                tot = 4 + _common_prefix(buf, pos + 4, c + 4,
                                         matchlimit - (pos + 4))
                bk = 0
                if lookback > 0:
                    maxb = min(lookback, c)
                    while bk < maxb and buf[pos - 1 - bk] == buf[c - 1 - bk]:
                        bk += 1
                tot += bk
                if tot > lg:
                    lg, offb, backb = tot, pos - c, bk
            # next candidate
            dlt = chain[c]
            applies = False
            if pa and c > 0 and dlt == 1:
                if rep == 0:
                    periodic = ((pat & 0xFFFF) == (pat >> 16)
                                and (pat & 255) == (pat >> 24))
                    if periodic:
                        spl = count_pat_fwd(pos + 4, pat, matchlimit) + 4
                    rep = 2 if periodic else 1
                cand = c - 1
                applies = (rep == 2 and cand >= lowest
                           and W[max(cand, 0)] == pat)
            if applies:
                fwd_pat = count_pat_fwd(cand + 4, pat, matchlimit) + 4
                back_pat = count_pat_rev(cand, pat, 0)
                if cand - back_pat < lowest:
                    back_pat = cand - lowest
                seg = back_pat + fwd_pat
                c_nf = cand - back_pat
                if seg >= spl and fwd_pat <= spl:
                    nc = cand + fwd_pat - spl
                    dead = nc < lowest
                elif lookback == 0:
                    brk = False
                    max_ml = min(seg, spl)
                    if lg < max_ml:
                        if pos - c_nf > WINDOW:
                            brk = True
                        else:
                            lg, offb, backb = max_ml, pos - c_nf, 0
                    dlt2 = chain[max(c_nf, 0)]
                    nc = c_nf - dlt2
                    dead = brk or dlt2 == 0 or nc < lowest
                else:
                    nc = c_nf
                    dead = c_nf < lowest
            else:
                nc = c - dlt
                dead = dlt == 0 or nc < lowest
            if dead:
                break
            tries -= 1
            c = nc
        return lg, offb, backb, ni

    def put_len(ln):
        out.extend(b"\xff" * (ln // 255))
        out.append(ln % 255)

    def emit(anchor, ip, off, mlen):
        litlen = ip - anchor
        mlc = mlen - 4
        out.append((min(litlen, 15) << 4) | min(mlc, 15))
        if litlen >= 15:
            put_len(litlen - 15)
        out.extend(buf[anchor:ip])
        out.append(off & 255)
        out.append(off >> 8)
        if mlc >= 15:
            put_len(mlc - 15)

    # the Search2/Search3 arbitration: state 0 scans for a first match m1
    # at ip (saved as m0 at s0), state 1 looks for a wider overlapping m2
    # at s2, state 2 for a third m3 at s3 past m2
    state, ip, anchor, ni = 0, 0, 0, 0
    m1l = m1o = s0 = m0l = m0o = s2 = m2l = m2o = 0
    while True:
        if state == 0:
            if ip > mflimit:
                break
            ml, mo, _, ni = lazy_search(ip, ip, 3, ni)
            if ml >= 4 and mo > 0:
                state, m1l, m1o, s0, m0l, m0o = 1, ml, mo, ip, ml, mo
            else:
                ip += 1
        elif state == 1:
            can2 = ip + m1l <= mflimit
            probe = ip + m1l - 2
            if can2:
                m2l, m2o, m2b, ni = lazy_search(probe, ip, m1l, ni)
            else:
                m2l, m2o, m2b = m1l, 0, 0
            s2 = probe - m2b
            if not (can2 and m2l > m1l and m2o > 0):
                emit(anchor, ip, m1o, m1l)       # nothing wider: commit m1
                ip += m1l
                anchor = ip
                state = 0
                continue
            if s0 < ip and s2 < ip + m0l:         # restore the saved m0
                ip, m1l, m1o = s0, m0l, m0o
            if s2 - ip < 3:                       # m1 too small: drop it
                ip, m1l, m1o = s2, m2l, m2o
            else:
                state = 2
        else:
            if s2 - ip < OPTIMAL_ML:              # pre-trim m1 against m2
                nml = min(m1l, OPTIMAL_ML)
                if ip + nml > s2 + m2l - 4:
                    nml = s2 - ip + m2l - 4
                corr = nml - (s2 - ip)
                if corr > 0:
                    s2 += corr
                    m2l -= corr
            can3 = s2 + m2l <= mflimit
            probe3 = s2 + m2l - 3
            if can3:
                m3l, m3o, m3b, ni = lazy_search(probe3, s2, m2l, ni)
            else:
                m3l, m3o, m3b = m2l, 0, 0
            s3 = probe3 - m3b
            if not (can3 and m3l > m2l and m3o > 0):
                # no better third: m1 (cut at s2), then m2
                if s2 < ip + m1l:
                    m1l = s2 - ip
                emit(anchor, ip, m1o, m1l)
                emit(ip + m1l, s2, m2o, m2l)
                ip = anchor = s2 + m2l
                state = 0
            elif s3 < ip + m1l + 3:
                if s3 >= ip + m1l:
                    # m2 dies: commit m1, m3 becomes m1, m2's rest m0
                    if s2 < ip + m1l:
                        corr = ip + m1l - s2
                        s2 += corr
                        m2l -= corr
                    if m2l < 4:
                        s2, m2l, m2o = s3, m3l, m3o
                    emit(anchor, ip, m1o, m1l)
                    anchor = ip + m1l
                    ip, m1l, m1o = s3, m3l, m3o
                    s0, m0l, m0o = s2, m2l, m2o
                    state = 1
                else:                             # m3 replaces m2
                    s2, m2l, m2o = s3, m3l, m3o
            else:
                # three ascending matches: commit a trimmed m1, shift
                if s2 < ip + m1l:
                    if s2 - ip < OPTIMAL_ML:
                        m1l = min(m1l, OPTIMAL_ML)
                        if ip + m1l > s2 + m2l - 4:
                            m1l = s2 - ip + m2l - 4
                        corr = m1l - (s2 - ip)
                        if corr > 0:
                            s2 += corr
                            m2l -= corr
                    else:
                        m1l = s2 - ip
                emit(anchor, ip, m1o, m1l)
                anchor = ip + m1l
                ip, m1l, m1o = s2, m2l, m2o
                s2, m2l, m2o = s3, m3l, m3o
    litlen = max(n - anchor, 0)
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        put_len(litlen - 15)
    out.extend(buf[anchor: anchor + litlen])
    return out, litlen


def encode_blocks_hc_plain(src, lens, *, cap_n: int, level: int = 9,
                           favor_dec_speed: bool = False):
    """Plain PyTorch version of B5 on CPU tensors: the kernel's machine
    step for step, in Python over each block's bytes, written into
    tensors of the kernel's contract."""
    _check_cap(cap_n)
    depth = depth_for(level)
    B = src.shape[0]
    bound = compress_bound(cap_n)
    out = torch.zeros((B, bound), dtype=torch.uint8)
    csizes = torch.zeros(B, dtype=torch.int32)
    trailing = torch.zeros(B, dtype=torch.int32)
    src_np = src.cpu().numpy()
    lens_l = lens.cpu().tolist()
    pad = bytes(_PAD)
    for b in range(B):
        n = min(max(lens_l[b], 0), cap_n)
        stream, trail = _encode_hc_one(src_np[b].tobytes() + pad, n, depth,
                                       bool(favor_dec_speed))
        k = min(len(stream), bound)
        out[b, :k] = torch.frombuffer(stream[:k], dtype=torch.uint8)
        csizes[b] = len(stream)
        trailing[b] = trail
    return out, csizes, trailing
