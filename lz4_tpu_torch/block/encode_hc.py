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

On the card each block is parsed by all the warps of one CTA of 32 warps,
or of two. The launcher asks once a device how many clusters of two such
CTAs the card holds at once (`plan`; 66 on an H100 SXM): a call of B
blocks up to that many runs at width 2, a cluster of two CTAs (two SMs) a
block, its positions cut into 256 speculative parts; a larger call runs at
width 1, min(B, SMs) CTAs each looping over blocks, 128 parts a block.
Each CTA of a pair keeps its own copy of the row and the chain deltas;
the pair's 64 warps share the parts, the joins and the write-out through
rank 0's shared memory. Nothing else picks the width, and the bytes are
the same at both.
"""
from __future__ import annotations

import ctypes

import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import result_rows, to_device_batch
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
#: those of them at width 2 (a 2-CTA cluster a block)
cluster_launches = 0
_plan_fn = None


def depth_for(level: int) -> int:
    """Chain search depth of an HC level (clamped to 0..12)."""
    return K_DEPTH[min(max(int(level), 0), 12)]


def plan(B: int) -> tuple[int, int]:
    """(width, clusters) of a B5 launch of B blocks on the current CUDA
    device: the 2-CTA clusters of the kernel the card holds at once, and 2
    where B is at most that, else 1 (the C launcher's rule)."""
    global _plan_fn
    if _plan_fn is None:
        _build.load("encode_hc")
        fn = ctypes.CDLL(_build.library_path("encode_hc")).lz4t_encode_hc_plan
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _plan_fn = fn
    width, clusters = ctypes.c_int(), ctypes.c_int()
    rc = _plan_fn(int(B), ctypes.byref(width), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"B5 plan failed: CUDA error {rc}")
    return width.value, clusters.value


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
    global launches, cluster_launches
    _check_cap(cap_n)
    device = src.device if isinstance(src, torch.Tensor) else None
    src, lens, _, _ = to_device_batch(src, lens, device=device)
    if src.shape[1] != cap_n:
        raise ValueError(f"src must be uint8[B, {cap_n}], got "
                         f"{tuple(src.shape)}")
    B, bound = src.shape[0], compress_bound(cap_n)
    outs = result_rows(B, bound, src.device)
    res, n = _build.launch(
        "encode_hc", "B5", src.device,
        lambda: encode_blocks_hc_plain(src, lens, cap_n=cap_n, level=level,
                                       favor_dec_speed=favor_dec_speed),
        outs, src, lens, *outs, B, cap_n, bound, depth_for(level),
        int(bool(favor_dec_speed)))
    launches += n
    if n:
        with torch.cuda.device(src.device):
            cluster_launches += plan(B)[0] == 2
    return res


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


def _hash15(seq):
    """The 15-bit Knuth hash of 4-byte words (int64 tensor), with no int64
    product that overflows: (seq * HASH_MUL) mod 2^32 in two halves."""
    lo = seq * (HASH_MUL & 0xFFFF)
    hi = ((seq * (HASH_MUL >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & _M32) >> (32 - HASH_LOG)


def _tables(buf: bytes):
    """read4 (4 bytes little-endian) and its hash at every position of buf
    (which ends in >= 3 zero bytes)."""
    t = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(torch.int64)
    seq = t[:-3] | (t[1:-2] << 8) | (t[2:-1] << 16) | (t[3:] << 24)
    return seq.tolist(), _hash15(seq).tolist()


def _periodic(pat: int) -> bool:
    """A 4-byte pattern that repeats with period 1 or 2."""
    return (pat & 0xFFFF) == (pat >> 16) and (pat & 255) == (pat >> 24)


def _searcher(buf, W, n, depth, favor, head_of, chain, *, score=None,
              pat_fwd=None, pat_rev=None, batched=None, visit=None):
    """lazy_search(pos, lowpos, lg) of one block: the widest match at pos
    that may back-extend to lowpos and beats lg, as (len, off, back); off
    0 means nothing beat lg. head_of(pos) is the last position below pos
    with pos's hash (-1: none), chain[q] = q - prev(q) (0: none) for every
    q below pos. score(pos, c, maxb) -> (total length, back), pat_fwd and
    pat_rev default to plain serial counts; a model of the kernel passes
    its own, `batched`, its walk where no candidate can take the
    repeat-pattern path, and `visit`, called at each candidate of the
    serial walk."""
    matchlimit = n - LASTLITERALS
    pa = depth > 128                                 # pattern analysis

    def plain_score(pos, c, maxb):
        bk = 0
        while bk < maxb and buf[pos - 1 - bk] == buf[c - 1 - bk]:
            bk += 1
        return 4 + _common_prefix(buf, pos + 4, c + 4,
                                  matchlimit - (pos + 4)) + bk, bk

    def plain_pat_fwd(q, pat, limit):
        """run length of the repeating 4-byte pattern starting at q"""
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

    def plain_pat_rev(q, pat, low):
        """run length of the pattern ending at q, scanning back to low"""
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

    score = score or plain_score
    pat_fwd = pat_fwd or plain_pat_fwd
    pat_rev = pat_rev or plain_pat_rev

    def lazy_search(pos, lowpos, lg):
        pat = W[pos]
        c = head_of(pos)
        lowest = max(pos - WINDOW, 0)
        lookback = pos - lowpos
        offb = backb = 0
        if c < 0 or not lowest <= c < pos:
            return lg, offb, backb
        if batched is not None and not (pa and _periodic(pat)):
            return batched(pos, lowpos, lg, c, lowest, pat)
        tries, rep, spl = depth, 0, 0
        while tries > 0:
            if visit is not None:
                visit()
            # score candidate c: the can-beat filter (addresses clamped at
            # 0), then forward and backward extension
            a1 = lowpos + lg - 1
            a2 = c - lookback + lg - 1
            if ((W[max(a1, 0)] & 0xFFFF) == (W[max(a2, 0)] & 0xFFFF)
                    and W[c] == pat and not (favor and pos - c < 8)):
                tot, bk = score(pos, c, min(lookback, c) if lookback > 0
                                else 0)
                if tot > lg:
                    lg, offb, backb = tot, pos - c, bk
            # next candidate
            dlt = chain[c]
            applies = False
            if pa and c > 0 and dlt == 1:
                if rep == 0:
                    periodic = _periodic(pat)
                    if periodic:
                        spl = pat_fwd(pos + 4, pat, matchlimit) + 4
                    rep = 2 if periodic else 1
                cand = c - 1
                applies = (rep == 2 and cand >= lowest
                           and W[max(cand, 0)] == pat)
            if applies:
                fwd_pat = pat_fwd(cand + 4, pat, matchlimit) + 4
                back_pat = pat_rev(cand, pat, 0)
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
        return lg, offb, backb

    return lazy_search


def _machine(search, mflimit, ip, at_scan, commit):
    """The Search2/Search3 arbitration from state 0 at ip: state 0 scans
    for a first match m1 at ip (saved as m0 at s0), state 1 looks for a
    wider overlapping m2 at s2, state 2 for a third m3 at s3 past m2.
    at_scan(ip) is asked at every state-0 turn before its search and stops
    the machine there when true; commit(start, mlen, off) takes each
    sequence in order (its literals run from the previous one's end).
    Returns the position of the state-0 turn it stopped at (> mflimit at
    the block's end). Which sequences follow a state-0 turn at ip depends
    on ip alone."""
    state, s0, s2 = 0, 0, 0
    m1l = m1o = m0l = m0o = m2l = m2o = 0
    while True:
        if state == 0:
            if ip > mflimit or at_scan(ip):
                return ip
            ml, mo, _ = search(ip, ip, 3)
            if ml >= 4 and mo > 0:
                state, m1l, m1o, s0, m0l, m0o = 1, ml, mo, ip, ml, mo
            else:
                ip += 1
        elif state == 1:
            can2 = ip + m1l <= mflimit
            probe = ip + m1l - 2
            if can2:
                m2l, m2o, m2b = search(probe, ip, m1l)
            else:
                m2l, m2o, m2b = m1l, 0, 0
            s2 = probe - m2b
            if not (can2 and m2l > m1l and m2o > 0):
                commit(ip, m1l, m1o)             # nothing wider: commit m1
                ip += m1l
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
                m3l, m3o, m3b = search(probe3, s2, m2l)
            else:
                m3l, m3o, m3b = m2l, 0, 0
            s3 = probe3 - m3b
            if not (can3 and m3l > m2l and m3o > 0):
                # no better third: m1 (cut at s2), then m2
                if s2 < ip + m1l:
                    m1l = s2 - ip
                commit(ip, m1l, m1o)
                commit(s2, m2l, m2o)
                ip = s2 + m2l
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
                    commit(ip, m1l, m1o)
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
                commit(ip, m1l, m1o)
                ip, m1l, m1o = s2, m2l, m2o
                s2, m2l, m2o = s3, m3l, m3o


def _emit(buf: bytes, n: int, seqs):
    """The LZ4 stream of sequences (start, mlen, off) in order, each with
    the literals from the previous one's end, then the final literal run.
    Returns (stream, final literal run)."""
    out = bytearray()

    def put_len(ln):
        out.extend(b"\xff" * (ln // 255))
        out.append(ln % 255)

    prev = 0
    for start, mlen, off in seqs:
        litlen = start - prev
        mlc = mlen - 4
        out.append((min(litlen, 15) << 4) | min(mlc, 15))
        if litlen >= 15:
            put_len(litlen - 15)
        out.extend(buf[prev:start])
        out.append(off & 255)
        out.append(off >> 8)
        if mlc >= 15:
            put_len(mlc - 15)
        prev = start + mlen
    litlen = max(n - prev, 0)
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        put_len(litlen - 15)
    out.extend(buf[prev: prev + litlen])
    return out, litlen


class _SerialInserts:
    """The serial parse's hash chains: a head per slot (-1: none) and
    chain[q] = q - prev(q) (0 ends a chain), positions inserted in order."""

    def __init__(self, H):
        self.H = H
        self.head = [-1] * (1 << HASH_LOG)
        self.chain = [0] * MAX_CAP_N
        self.ni = 0                                  # next to insert

    def head_of(self, pos):
        """Insert [ni, pos) in order (re-inserting the current head keeps
        its chain link); returns the head of pos's hash."""
        H, head, chain = self.H, self.head, self.chain
        for q in range(self.ni, pos):
            h = H[q]
            e = head[h]
            if e != q:
                d = q - e if e >= 0 else 0
                chain[q] = d if 0 < d <= WINDOW else 0
            head[h] = q
        self.ni = max(self.ni, pos)
        return head[H[pos]]


def _encode_hc_one(buf: bytes, n: int, depth: int, favor: bool):
    """One block: buf = [block row | >= _PAD zeros]. Positions are
    inserted into the hash chains in order, each before any search above
    it. Returns (stream, final literal run)."""
    W, H = _tables(buf)
    ins = _SerialInserts(H)
    seqs = []
    _machine(_searcher(buf, W, n, depth, favor, ins.head_of, ins.chain),
             n - MFLIMIT, 0, lambda ip: False,
             lambda *seq: seqs.append(seq))
    return _emit(buf, n, seqs)


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


# --------------------------------------------------------------------------
# the kernel's design on the CPU: the pre-pass, the segmented parse and the
# warp's counts lane by lane (a model for the tests)
# --------------------------------------------------------------------------

WARP = 32
SEGMENTS = 128                 # speculative parses per block at width 1
PAIR_SEGMENTS = 256            # at width 2 (B5's parts on a 2-CTA cluster)


def chain_deltas(src, lens, *, cap_n: int):
    """B5's pre-pass, vectorised: chain[b, q] = q - prev(q) for every
    position q a search of row b can reach (q <= n_b - 12), where prev(q)
    is the last q' < q whose 4 bytes hash to q's 15-bit slot; 0 where there
    is none and past the last position. A stable sort by (slot, position)
    puts each slot's positions in order. int32[B, cap_n]."""
    _check_cap(cap_n)
    B = src.shape[0]
    t = torch.zeros((B, cap_n + 3), dtype=torch.int64)
    t[:, :cap_n] = src.cpu().to(torch.int64)
    seq = t[:, :-3] | (t[:, 1:-2] << 8) | (t[:, 2:-1] << 16) | (t[:, 3:] << 24)
    npos = (lens.cpu().to(torch.int64).clamp(0, cap_n) - MFLIMIT + 1).clamp(
        min=0)
    live = torch.arange(cap_n)[None, :] < npos[:, None]
    key = torch.where(live, _hash15(seq), 1 << HASH_LOG)
    skey, order = torch.sort(key, dim=1, stable=True)
    same = (skey[:, 1:] == skey[:, :-1]) & (skey[:, 1:] < (1 << HASH_LOG))
    delta = torch.where(same, order[:, 1:] - order[:, :-1], 0)
    chain = torch.zeros((B, cap_n), dtype=torch.int64)
    chain.scatter_(1, order[:, 1:], delta)
    return chain.to(torch.int32)


def pair_order(segments: int = PAIR_SEGMENTS) -> list[int]:
    """The parts of a block in an order a pair of CTAs may take them from
    their shared counter: in turns from the two halves (0, S/2, 1, S/2 + 1,
    ...), so that with `ctas=2` the first CTA takes the first half and the
    second the second half."""
    half = -(-segments // 2)
    out = []
    for i in range(half):
        out += [i] + ([half + i] if half + i < segments else [])
    return out


def segment_caps(cap_n: int, segments: int = SEGMENTS):
    """Sequence-list capacities of B5's scratch: a speculative parse's
    list (a quarter of its segment plus slack; one that fills stops at its
    last state-0 turn before) and a repair's (one that fills sends the
    block to the serial parse)."""
    return -(-cap_n // (4 * segments)) + 128, 256


class HCLockstepModel:
    """B5 as its kernel runs it, on the CPU, for the tests.

    The parse reads only the pre-pass's delta table (`chain_deltas`; the
    head of a search at pos is pos - chain[pos]). The block's searchable
    positions are cut into `segments` equal parts, which the kernel's
    warps take in turn. Each part is parsed speculatively, from state 0 at
    its first position, up to its first state-0 turn at or past the next
    part (or its list's capacity), marking every state-0 position it
    searches from. Which sequences follow a state-0 turn depends on its
    position alone, so the true parse, once it reaches a state-0 turn that
    a later part marked, follows that part's parse from there. Then the
    join after each part is repaired: the true machine from where the
    part's parse stopped up to the first
    valid mark (a mark below its owner's end). The stream is part 0's
    sequences, then repairs and the adopted parses' suffixes in turn; a
    repair that fills its list sends the block to one serial parse. Chain
    walks that cannot take the repeat-pattern path go 32 candidates a
    step (a walk ahead, then the candidates scored in chain order against
    the running best); the forward and back counts and the pattern counts
    go lane by lane, 128, 32 and 128 bytes a warp step.

    Counts: `searches`, `candidates`, `scored` (passed the can-beat filter
    and were scored in full), `bytes` (equal bytes the counts found),
    `steps` (warp steps of the counts), `syncs` (joins a repair closed on
    a mark), `repaired` (sequences the repairs made), `fallbacks`. With
    `serial_check` (one segment only) it also runs the serial inserts and
    asserts, at every search, that search positions never decrease and
    that the pre-pass table holds what the inserts have written. With
    `batched` off every chain is walked one candidate a step (the
    kernel's `LZ4T_B5_SERIAL_WALK` build).

    `order` (a permutation of the segments; default in turn) is the order
    in which the parts are taken, in both phases, and `ctas` the CTAs
    that take them: the i-th part taken marks in CTA i % ctas's own
    marks, which are ORed together before the repairs, as a pair of CTAs
    does (`pair_order`, `ctas=2`)."""

    def __init__(self, segments: int = SEGMENTS, caps=None,
                 serial_check: bool = False, batched: bool = True,
                 order=None, ctas: int = 1):
        if serial_check and segments != 1:
            raise ValueError("serial_check needs one segment")
        order = list(range(segments)) if order is None else list(order)
        if sorted(order) != list(range(segments)):
            raise ValueError("order must be a permutation of the segments")
        self.segments = segments
        self.caps = caps
        self.serial_check = serial_check
        self.batched = batched
        self.order = order
        self.ctas = ctas
        self.searches = self.candidates = self.scored = self.bytes = 0
        self.steps = self.syncs = self.repaired = self.fallbacks = 0

    # ---------------------------------------------------------- one block
    def encode_one(self, buf, n, depth, favor, chain, cap_n):
        W, H = _tables(buf)
        matchlimit = n - LASTLITERALS
        model = self
        serial = _SerialInserts(H) if self.serial_check else None
        last = [0]

        def head_of(pos):
            model.searches += 1
            if serial is not None:
                assert pos >= last[0], "search positions decreased"
                ni = serial.ni
                e = serial.head_of(pos)
                assert serial.chain[ni:pos] == chain[ni:pos], pos
                assert e == (pos - chain[pos] if chain[pos] else -1), pos
            last[0] = pos
            d = chain[pos]
            return pos - d if d else -1

        def read16c(q):
            return W[max(q, 0)] & 0xFFFF

        def good(q1, q2, ci, maxn):
            """a lane's 4 forward bytes: how many are equal (< 4: the
            first mismatch or maxn)"""
            if ci >= maxn:
                return 0
            x = W[q1 + ci] ^ W[q2 + ci]
            g = ((x & -x).bit_length() - 1) >> 3 if x else 4
            return min(g, maxn - ci)

        def fwd_from(q1, q2, maxn, c0):
            c = c0
            while c < maxn:
                model.steps += 1
                if (c + 4 * WARP <= maxn and buf[q1 + c: q1 + c + 4 * WARP]
                        == buf[q2 + c: q2 + c + 4 * WARP]):
                    c += 4 * WARP                 # every lane's 4 bytes equal
                    continue
                goods = [good(q1, q2, c + 4 * k, maxn) for k in range(WARP)]
                f = next((k for k, g in enumerate(goods) if g < 4), None)
                if f is not None:
                    return c + 4 * f + goods[f]
                c += 4 * WARP
            return maxn

        def back_from(p, c, kmax, k0):
            k = k0
            while k < kmax:
                model.steps += 1
                stops = [k + i >= kmax
                         or buf[p - 1 - k - i] != buf[c - 1 - k - i]
                         for i in range(WARP)]
                if any(stops):
                    return k + stops.index(True)
                k += WARP
            return kmax

        def score(pos, c, maxb):
            # the back count and the first forward step in one warp step
            q1, q2 = pos + 4, c + 4
            maxn = matchlimit - q1
            model.steps += 1
            stops = [i >= maxb or buf[pos - 1 - i] != buf[c - 1 - i]
                     for i in range(WARP)]
            goods = [good(q1, q2, 4 * k, maxn) for k in range(WARP)]
            bk = stops.index(True) if any(stops) else back_from(pos, c, maxb,
                                                                WARP)
            f = next((k for k, g in enumerate(goods) if g < 4), None)
            fc = 4 * f + goods[f] if f is not None else fwd_from(
                q1, q2, maxn, 4 * WARP)
            model.scored += 1
            model.bytes += fc + bk
            return 4 + fc + bk, bk

        def pat_fwd(q, pat, limit):
            p = q
            run = pat.to_bytes(4, "little") * WARP
            while True:
                model.steps += 1
                if p + 4 * WARP <= limit and buf[p: p + 4 * WARP] == run:
                    p += 4 * WARP                 # every lane's word matches
                    continue
                oks = [p + 4 * k + 4 <= limit and W[p + 4 * k] == pat
                       for k in range(WARP)]
                if not all(oks):
                    p += 4 * oks.index(False)
                    break
                p += 4 * WARP
            x = pat
            for _ in range(3):
                if not (p < limit and buf[p] == (x & 255)):
                    break
                p += 1
                x = (x >> 8) | ((x << 24) & _M32)
            model.bytes += p - q
            return p - q

        def pat_rev(q, pat, low):
            p = q
            run = pat.to_bytes(4, "little") * WARP
            while True:
                model.steps += 1
                if p - 4 * WARP >= low + 4 and buf[p - 4 * WARP: p] == run:
                    p -= 4 * WARP                 # every lane's word matches
                    continue
                oks = [p - 4 * k >= low + 4 and W[p - 4 * k - 4] == pat
                       for k in range(WARP)]
                if not all(oks):
                    p -= 4 * oks.index(False)
                    break
                p -= 4 * WARP
            x = pat
            for _ in range(3):
                if not (p > low and buf[max(p - 1, 0)] == (x >> 24)):
                    break
                p -= 1
                x = ((x << 8) & _M32) | (x >> 24)
            model.bytes += q - p
            return q - p

        def batched(pos, lowpos, lg, c, lowest, pat):
            lookback = pos - lowpos
            best = (lg, 0, 0)
            f1 = read16c(lowpos + lg - 1)
            tries = depth
            while True:
                lanes, cur, more = [], c, True    # the walk ahead
                for _ in range(min(WARP, tries)):
                    lanes.append(cur)
                    d = chain[cur]
                    if d == 0 or cur - d < lowest:
                        more = False
                        break
                    cur -= d
                model.candidates += len(lanes)
                rest = [k for k, m in enumerate(lanes)
                        if W[m] == pat and not (favor and pos - m < 8)]
                while rest:                       # in chain order
                    passing = [k for k in rest if read16c(
                        lanes[k] - lookback + best[0] - 1) == f1]
                    if not passing:
                        break
                    f = passing[0]
                    cf = lanes[f]
                    tot, bk = score(pos, cf, min(lookback, cf)
                                    if lookback > 0 else 0)
                    if tot > best[0]:
                        best = (tot, pos - cf, bk)
                        f1 = read16c(lowpos + tot - 1)
                    rest = [k for k in rest if k > f]
                tries -= len(lanes)
                if not more or tries <= 0:
                    return best
                c = cur

        def visit():
            model.candidates += 1

        search = _searcher(buf, W, n, depth, favor, head_of, chain,
                           score=score, pat_fwd=pat_fwd, pat_rev=pat_rev,
                           batched=batched if self.batched else None,
                           visit=visit)
        return _emit(buf, n, self.parse(search, n, cap_n))

    # -------------------------------------------------- the segmented parse
    def parse(self, search, n, cap_n):
        """The block's sequences, from the speculative parses, the repairs
        and the stitch, as the kernel runs them."""
        S = self.segments
        spec_cap, rep_cap = self.caps or segment_caps(cap_n, S)
        mflimit = n - MFLIMIT
        L = max(mflimit + 1, 0)
        seg = -(-L // S)
        starts = [min(w * seg, L) for w in range(S)] + [L]
        marks = [bytearray(L) for _ in range(self.ctas)]
        specs, ends = [None] * S, [None] * S
        for i, w in enumerate(self.order):
            lst = []
            st = {"last": (starts[w], 0), "full": False}

            def at_scan(ip, hi=starts[w + 1], lst=lst, st=st,
                        mark=marks[i % self.ctas]):
                if st["full"] or ip >= hi:
                    return True
                mark[ip] = 1
                st["last"] = (ip, len(lst))
                return False

            def commit(*seq, lst=lst, st=st):
                if len(lst) < spec_cap:
                    lst.append(seq)
                else:
                    st["full"] = True

            e = _machine(search, mflimit, starts[w], at_scan, commit)
            if st["full"]:      # back to its last state-0 turn
                e, k = st["last"]
                del lst[k:]
            specs[w] = lst
            ends[w] = e
        mark = marks[0]         # each CTA's marks, ORed
        for m in marks[1:]:
            mark = bytes(a | b for a, b in zip(mark, m))

        def owner(ip):
            return ip // seg

        repairs, overflow = [None] * S, False
        for w in self.order:
            lst, st = [], {"sync": None}

            def at_scan(ip, st=st):
                if mark[ip] and ip < ends[owner(ip)]:
                    st["sync"] = ip
                    return True
                return False

            def commit(*seq, lst=lst):
                nonlocal overflow
                if len(lst) < rep_cap:
                    lst.append(seq)
                else:
                    overflow = True

            _machine(search, mflimit, ends[w], at_scan, commit)
            repairs[w] = (lst, st["sync"])
        if overflow:
            self.fallbacks += 1
            seqs = []
            _machine(search, mflimit, 0, lambda ip: False,
                     lambda *seq: seqs.append(seq))
            return seqs
        seqs, w = list(specs[0]), 0
        while ends[w] <= mflimit:
            lst, sync = repairs[w]
            seqs += lst
            self.repaired += len(lst)
            if sync is None:
                break
            self.syncs += 1
            w = owner(sync)
            seqs += [s for s in specs[w] if s[0] >= sync]
        return seqs


def encode_blocks_hc_lockstep(src, lens, *, cap_n: int, level: int = 9,
                              favor_dec_speed: bool = False, model=None):
    """`encode_blocks_hc_plain` with B5's design modelled (see
    `HCLockstepModel`; for the tests). Returns the plain version's tensors
    and the model with its counts."""
    _check_cap(cap_n)
    model = model or HCLockstepModel()
    depth = depth_for(level)
    B = src.shape[0]
    bound = compress_bound(cap_n)
    out = torch.zeros((B, bound), dtype=torch.uint8)
    csizes = torch.zeros(B, dtype=torch.int32)
    trailing = torch.zeros(B, dtype=torch.int32)
    chains = chain_deltas(src, lens, cap_n=cap_n).tolist()
    src_np = src.cpu().numpy()
    lens_l = lens.cpu().tolist()
    pad = bytes(_PAD)
    for b in range(B):
        n = min(max(lens_l[b], 0), cap_n)
        stream, trail = model.encode_one(src_np[b].tobytes() + pad, n, depth,
                                         bool(favor_dec_speed), chains[b],
                                         cap_n)
        k = min(len(stream), bound)
        out[b, :k] = torch.frombuffer(stream[:k], dtype=torch.uint8)
        csizes[b] = len(stream)
        trailing[b] = trail
    return out, csizes, trailing, model
