"""Batched fast-tier block encode: kernel B1 (`csrc/encode_serial.cu`)
and its plain PyTorch version.

Contract of `lz4_tpu.block.encode_pallas.encode_blocks_pallas`:
src uint8[B, cap_n], lens int32[B], optionally dict_bufs uint8[B, 65536]
(right-aligned history) with dict_lens int32[B] ->
(out uint8[B, compress_bound(cap_n)], csizes int32[B], trailing int32[B]),
where out[b, :csizes[b]] is block b's LZ4 stream and trailing[b] the
length of its final literal run. Bytes of out past csizes are
unspecified. The kernel takes the 64 KB tier (cap_n <= 65536); larger
blocks go through the engine as linked 64 KB segments. A length outside
[0, cap_n] is clamped into it.

On the card a call of B blocks up to the card's SMs runs solo (`plan`):
one CTA a block, each alone on its SM with the block's row and its hash
table in shared memory (in dict mode one window holds the history and
the block's bytes up to LEAD past the anchor), its other warps writing
the output the parse warp hands them; a larger call runs one warp a
block, up to 8 an SM, with the tables in device memory. Nothing else
picks the path, and the bytes are the same on both.
"""
from __future__ import annotations

import ctypes

import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import DICT_CAP, result_rows, to_device_batch
from lz4_tpu_torch.constants import (ACCELERATION_MAX, LASTLITERALS,
                                     MFLIMIT, MINMATCH, compress_bound)

HASH_LOG = 16
HASH_MUL = 2654435761          # Knuth multiplier
SKIP_TRIGGER = 6
MAX_CAP_N = 65536

#: kernel launches made by `encode_blocks` (and nowhere else)
launches = 0
#: those of them on the solo path (a whole SM a block, in shared memory)
smem_launches = 0
#: those of them given a history (`dict_bufs`): B1's dict instantiation
dict_launches = 0
_plan_fn = None


def _check(acceleration, dict_stride, max_dist, cap_n):
    if not 0 <= cap_n <= MAX_CAP_N:
        raise ValueError(f"cap_n must be in [0, {MAX_CAP_N}], got {cap_n}")
    if dict_stride < 1:
        raise ValueError(f"dict_stride must be >= 1, got {dict_stride}")
    if not 1 <= max_dist <= 65535:
        raise ValueError(f"max_dist must be in [1, 65535], got {max_dist}")
    # the reference acceleration range (lz4.c:52-58)
    return min(max(int(acceleration), 1), ACCELERATION_MAX)


def plan(B: int, has_dict: bool = False) -> tuple[bool, int]:
    """(solo, SMs) of a B1 launch of B blocks on the current CUDA device:
    whether it takes the solo path (B at most the card's SMs, where the
    card holds the solo kernel's shared memory) and the card's SMs (the C
    launcher's rule)."""
    global _plan_fn
    if _plan_fn is None:
        _build.load("encode_serial")
        fn = ctypes.CDLL(
            _build.library_path("encode_serial")).lz4t_encode_serial_plan
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _plan_fn = fn
    solo, sms = ctypes.c_int(), ctypes.c_int()
    rc = _plan_fn(int(B), int(bool(has_dict)), ctypes.byref(solo),
                  ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"B1 plan failed: CUDA error {rc}")
    return bool(solo.value), sms.value


def encode_blocks(src, lens, dict_bufs=None, dict_lens=None, *, cap_n: int,
                  acceleration: int = 1, dict_stride: int = 3,
                  max_dist: int = 65535):
    """Encode a batch of blocks (see the module docstring).

    Tensors stay on their device: CPU tensors run the plain version, CUDA
    tensors launch B1. numpy arrays go to the GPU (raising where there is
    none).
    """
    global launches, smem_launches, dict_launches
    accel = _check(acceleration, dict_stride, max_dist, cap_n)
    device = src.device if isinstance(src, torch.Tensor) else None
    src, lens, dict_bufs, dict_lens = to_device_batch(
        src, lens, dict_bufs, dict_lens, device=device)
    if src.shape[1] != cap_n:
        raise ValueError(f"src must be uint8[B, {cap_n}], got "
                         f"{tuple(src.shape)}")
    B, bound = src.shape[0], compress_bound(cap_n)
    outs = result_rows(B, bound, src.device)
    res, n = _build.launch(
        "encode_serial", "B1", src.device,
        lambda: encode_blocks_plain(src, lens, dict_bufs, dict_lens,
                                    cap_n=cap_n, acceleration=accel,
                                    dict_stride=dict_stride,
                                    max_dist=max_dist),
        outs, src, lens, dict_bufs, dict_lens, *outs, B, cap_n, bound,
        int(dict_bufs is not None), accel, dict_stride, max_dist)
    launches += n
    if n:
        has_dict = dict_bufs is not None
        dict_launches += has_dict
        with torch.cuda.device(src.device):
            smem_launches += plan(B, has_dict)[0]
    return res


# --------------------------------------------------------------------------
# plain version: the same greedy parse, step for step, in Python
# --------------------------------------------------------------------------

def _words_and_hashes(buf: bytes):
    """read4 (4 bytes little-endian) and its table slot at every
    position of buf (which ends in >= 3 zero bytes)."""
    t = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(torch.int64)
    seq = t[:-3] | (t[1:-2] << 8) | (t[2:-1] << 16) | (t[3:] << 24)
    # (seq * HASH_MUL) mod 2^32 in two halves, so no int64 product overflows
    lo = seq * (HASH_MUL & 0xFFFF)
    hi = ((seq * (HASH_MUL >> 16)) & 0xFFFF) << 16
    h = (((lo + hi) & 0xFFFFFFFF) >> (32 - HASH_LOG))
    return seq.tolist(), h.tolist()


def _fwd_count(buf: bytes, q1: int, q2: int, maxn: int) -> int:
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


def _put_len(out: bytearray, ln: int) -> None:
    out += b"\xff" * (ln // 255)
    out.append(ln % 255)


def _scan_serial(seq, hsh, tab, sp, accel0, low, mflimit, matchlimit,
                 max_dist, tail=None):
    """The reference scan from sp, after the previous match's tail insert
    (slot, position): two probes per step, each inserting before it
    checks. Returns (match position, candidate) or (None, None)."""
    if tail is not None:
        tab[tail[0]] = tail[1]
    srch = accel0
    while sp <= mflimit:
        sp1 = sp + (srch >> SKIP_TRIGGER)
        sp1c = min(sp1, matchlimit)
        h0 = hsh[sp]
        e0 = tab[h0]
        tab[h0] = sp
        if low <= e0 < sp and sp - e0 <= max_dist and seq[e0] == seq[sp]:
            return sp, e0
        h1 = hsh[sp1c]
        e1 = tab[h1]
        tab[h1] = sp1c
        if (sp1 <= mflimit and low <= e1 < sp1 and sp1 - e1 <= max_dist
                and seq[e1] == seq[sp1c]):
            return sp1, e1
        sp = sp1 + ((srch + 1) >> SKIP_TRIGGER)
        srch += 2
    return None, None


def _encode_one(buf: bytes, n: int, d0: int, low: int, accel0: int,
                dict_stride: int, max_dist: int, model=None, cap_n=0):
    """One block: buf = [d0 history bytes | block row (cap_n) | zeros].
    With a `LockstepModel`, its history pre-insert and scan replace the
    serial ones, and it sees each sequence."""
    seq, hsh = _words_and_hashes(buf)
    tab = [0] * (1 << HASH_LOG)
    mflimit = d0 + n - MFLIMIT
    matchlimit = d0 + n - LASTLITERALS
    scan = _scan_serial if model is None else model.scan

    if model is None:
        for q in range(low, d0, dict_stride):      # history pre-insert
            tab[hsh[q]] = q
    else:
        model.preinsert(tab, hsh, low, d0, dict_stride)
        model.begin(buf, d0, n, cap_n)

    def find(sp, tail=None):
        return scan(seq, hsh, tab, sp, accel0, low, mflimit, matchlimit,
                    max_dist, tail)

    out = bytearray()
    anchor = d0
    p, cand = find(d0)
    while p is not None:
        p2, c2 = p, cand
        while p2 > anchor and c2 > low and buf[p2 - 1] == buf[c2 - 1]:
            p2 -= 1
            c2 -= 1
        offset = p2 - c2
        fc = _fwd_count(buf, p + MINMATCH, cand + MINMATCH,
                        matchlimit - (p + MINMATCH))
        ml = (p - p2) + MINMATCH + fc
        if model is not None:
            model.sequence(p, cand, anchor, low, p - p2, fc, matchlimit,
                           p2 + ml)
        litlen = p2 - anchor
        m4 = ml - MINMATCH
        out.append((min(litlen, 15) << 4) | min(m4, 15))
        if litlen >= 15:
            _put_len(out, litlen - 15)
        out += buf[anchor:p2]
        out.append(offset & 255)
        out.append(offset >> 8)
        if m4 >= 15:
            _put_len(out, m4 - 15)
        t2 = p2 + ml - 2                  # tail insert, before the scan
        anchor = p2 + ml
        p, cand = find(anchor, (hsh[t2], t2))
    litlen = max(d0 + n - anchor, 0)
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        _put_len(out, litlen - 15)
    out += buf[anchor: anchor + litlen]
    return out, litlen


def _encode_batch(src, lens, dict_bufs, dict_lens, cap_n, acceleration,
                  dict_stride, max_dist, model=None):
    accel = _check(acceleration, dict_stride, max_dist, cap_n)
    B = src.shape[0]
    bound = compress_bound(cap_n)
    out = torch.zeros((B, bound), dtype=torch.uint8)
    csizes = torch.zeros(B, dtype=torch.int32)
    trailing = torch.zeros(B, dtype=torch.int32)
    src_np = src.cpu().numpy()
    lens_l = lens.cpu().tolist()
    has_dict = dict_bufs is not None
    if has_dict:
        dict_np = dict_bufs.cpu().numpy()
        dlens_l = dict_lens.cpu().tolist()
    d0 = DICT_CAP if has_dict else 0
    pad = bytes(16)
    for b in range(B):
        n = min(max(lens_l[b], 0), cap_n)
        if has_dict:
            low = d0 - min(dlens_l[b], d0)
            buf = dict_np[b].tobytes() + src_np[b].tobytes() + pad
        else:
            low = 0
            buf = src_np[b].tobytes() + pad
        stream, trail = _encode_one(buf, n, d0, low, accel << SKIP_TRIGGER,
                                    dict_stride, max_dist, model, cap_n)
        out[b, : len(stream)] = torch.frombuffer(stream, dtype=torch.uint8)
        csizes[b] = len(stream)
        trailing[b] = trail
    return out, csizes, trailing


def encode_blocks_plain(src, lens, dict_bufs=None, dict_lens=None, *,
                        cap_n: int, acceleration: int = 1,
                        dict_stride: int = 3, max_dist: int = 65535):
    """Plain PyTorch version of B1 on CPU tensors: the kernel's greedy
    parse step for step, in Python over each block's bytes, written into
    tensors of the kernel's contract."""
    return _encode_batch(src, lens, dict_bufs, dict_lens, cap_n,
                         acceleration, dict_stride, max_dist)


# --------------------------------------------------------------------------
# the kernel's lockstep scan, lane by lane (a model for the tests)
# --------------------------------------------------------------------------

WARP = 32
#: block bytes the dict solo path stages into its window past the anchor,
#: how far past it the served part always reaches, and the least bytes
#: it stages at once (but to catch up): the kernel's kLead, kNear and
#: kStageMin, which a test reads from its source as it does kReach
LEAD = 8192
NEAR = LEAD // 2
STAGE_MIN = 512
#: a window cuts a probe pair whose odd probe lies within REACH of the
#: served part's end (the kernel's kReach)
REACH = 160


def window_positions(wp: int, j0: int):
    """The kernel's probe positions for one window: the window's first
    probe sits at wp with srch j0, and the gap from probe i to i + 1 is
    (j0 + i) >> SKIP_TRIGGER. Returns the 32 positions and the next
    window's wp."""
    qa, ra = j0 >> SKIP_TRIGGER, j0 & 63
    pos = [wp + k * qa + max(0, k - (64 - ra)) for k in range(WARP)]
    return pos, wp + WARP * qa + max(0, ra - WARP)


class LockstepModel:
    """B1's scan as its warp runs it, one window of 32 probes a step, with
    the previous match's tail insert folded into the first window as a
    probe before lane 0, and its parallel history pre-insert (an atomic
    max per slot, here in reverse order). Counts `windows`, `shared`
    (committed probes that took their candidate from a lower lane of the
    same hash), `tails` (probes that took the pending tail insert as
    their candidate) and `hits`.

    With a history it also models the dict solo path's shared-memory
    window (`WinSource` in `csrc/encode_serial.cu`): every read the parse
    warp makes, lane by lane (probes, candidates, the back and forward
    counts in their warp steps, the tail insert's hash) against its
    staging (block bytes up to LEAD past the anchor in 16-byte pieces,
    STAGE_MIN or more at once, of which at least NEAR past it are served
    once a sequence ends; the newest pieces in flight are not, unless
    that falls short of NEAR; a forward count stages on as if the anchor
    were where its match has reached), and the window's cut: a probe
    pair (an even lane and the odd one after it) whose odd probe lies
    past the served part's end less REACH neither inserts nor takes a
    match, so a scan that reaches one before a match or the block's end
    leaves the window (`left`): the kernel's parse goes on from there
    with the row, and the model follows the block's reads no further. It
    asserts, while in the window, that no read of the history falls
    below the anchor's block index + 1 (which lets a history slot take a
    block byte once the anchor passes it) nor in a slot staged over, and
    that no block read runs past the served part; and counts the reads
    as the kernel's counting build does: `hist_reads` (the window's
    history), `block_reads` (block bytes) and `staged` (bytes); besides,
    `hist_windows` (windows in which some lane read a candidate in the
    history) and `hist_sequences` (matches whose candidate lies there).
    """

    def __init__(self):
        self.windows = self.shared = self.hits = self.tails = 0
        self.hist_reads = self.block_reads = self.left = 0
        self.staged = self.hist_windows = self.hist_sequences = 0
        self.d0 = 0
        self.win = False

    @staticmethod
    def preinsert(tab, hsh, low, d0, dict_stride):
        for q in reversed(range(low, d0, dict_stride)):
            tab[hsh[q]] = max(tab[hsh[q]], q)

    def begin(self, buf, d0, n, cap_n):
        """A block's start: block bytes [0, LEAD) are in the window, and
        it stages on up to the block's end rounded up to 16. A row not
        of a multiple of 16 bytes goes to the row from the start."""
        self.buf, self.d0 = buf, d0
        self.anchor = d0
        self.pending = None
        self.served = self.issued = LEAD
        self.end = min((n + 15) & ~15, cap_n)
        self.win = d0 > 0 and cap_n % 16 == 0
        self.left += d0 > 0 and not self.win

    def _read(self, q, width, check=True):
        """A read of the window at q (check: one whose bytes are used, so
        it has to find them in their slot)."""
        if not self.win:
            return
        if q >= self.d0:
            self.block_reads += 1
            if check and q - self.d0 + width > self.served:
                raise AssertionError(
                    f"block read at {q - self.d0} past the served part "
                    f"({self.served})")
            return
        self.hist_reads += 1
        if check and q <= self.anchor - self.d0:
            raise AssertionError(
                f"history read at {q} below the anchor's block index + 1 "
                f"({self.anchor - self.d0 + 1})")
        if check and q < self.issued - LEAD:
            raise AssertionError(
                f"history read at {q} of a slot staged over (below "
                f"{self.issued - LEAD})")

    def _stage(self, ax):
        if not self.win:
            return
        t = min(self.end, (ax + LEAD) & ~15)
        need = min(self.end, ax + NEAR)
        if t - self.issued < STAGE_MIN and self.served >= need:
            return
        old = self.issued
        self.issued = max(old, t)
        self.staged += self.issued - old
        if self.served < need:
            self.served = old if self.issued > old and old >= need \
                else self.issued

    def _cut_from(self, positions):
        """The first lane of the window's cut probe pairs (None: none)."""
        if not self.win or self.served >= self.end:
            return None
        reach = self.d0 + self.served - REACH
        return next((k for k in range(0, WARP, 2)
                     if positions[k + 1] > reach), None)

    def sequence(self, p, cand, anchor, low, kb, fc, matchlimit, nxt):
        """The kernel's reads after a scan's hit at p (candidate cand,
        back count kb, forward count fc), up to the next scan from nxt:
        the back and forward counts' warp steps where the scan's compare
        did not settle the match and the tail insert's hash on every lane;
        the staging for the new anchor follows the next scan's first
        window's loads."""
        if not self.win:
            return
        self.hist_sequences += cand < self.d0
        self.anchor = anchor
        q1, q2 = p + MINMATCH, cand + MINMATCH
        maxn = matchlimit - q1
        if ((self.ext & 7) == 4 and maxn > 4) or self.ext & 8:
            kmax = min(p - anchor, cand - low)
            for i in range(min(kmax, (kb // 32 + 1) * 32)):
                self._read(p - 1 - i, 1)
                self._read(cand - 1 - i, 1)
            for c in range(0, min(maxn, (fc // 128 + 1) * 128), 4):
                if c >= 128 and c % 128 == 0:   # fwd_count stages on
                    self._stage(q1 + c - self.d0)
                self._read(q1 + c, 4)
                self._read(q2 + c, 4)
        for _ in range(WARP):
            self._read(nxt - 2, 4)
        self.pending = nxt - self.d0

    def _candidate(self, q, e, low, check):
        """A lane's compare of its candidate e for probe q: its reads (the
        4 bytes at e, the next 4 at both, and the byte before both where
        the match may extend back; check: a lane not cut, whose bytes are
        used); returns the scan's ext (equal bytes of the next 4, bit 3
        for the byte before)."""
        buf = self.buf
        back = min(q - self.anchor, e - low) > 0
        for r in (e, q + 4, e + 4):
            self._read(r, 4, check)
        if back:
            self._read(q - 1, 1, check)
            self._read(e - 1, 1, check)
        f = 0
        while f < 4 and buf[q + 4 + f] == buf[e + 4 + f]:
            f += 1
        return f | (back and buf[q - 1] == buf[e - 1]) << 3

    def scan(self, seq, hsh, tab, p, accel0, low, mflimit, matchlimit,
             max_dist, tail=None):
        ht, t2 = tail if tail is not None else (None, None)
        wp, j0 = p, accel0
        self.anchor = p
        while True:
            self.windows += 1
            positions, wp = window_positions(wp, j0)
            cut = self._cut_from(positions)
            lanes = []
            for k, pos in enumerate(positions):
                active = canhit = pos <= mflimit
                q = pos
                if k & 1:           # sp1: inserts whenever its sp ran
                    active = pos - ((j0 + k - 1) >> SKIP_TRIGGER) <= mflimit
                    q = min(pos, matchlimit)
                h = hsh[q] if active else 0x10000 + k
                if active:    # a cut lane reads too, but serves nothing
                    self._read(q, 4, cut is None or k < cut)
                lanes.append([active, canhit, q, h,
                              tab[h] if active else 0, 0])
            if self.pending is not None:
                # staging for the new anchor: after the next scan's first
                # window has loaded, before its candidates are read
                self._stage(self.pending)
                self.pending = None
            # __match_any_sync, masked to lower lanes
            last_of = {}
            lower_of = []
            for k, (_, _, q, h, _, _) in enumerate(lanes):
                lower_of.append(last_of.get(h))
                last_of[h] = k
            hits = []
            touched = False
            for k, lane in enumerate(lanes):
                active, canhit, q, h, e, _ = lane
                if lower_of[k] is not None:
                    e = lane[4] = lanes[lower_of[k]][2]
                elif active and h == ht:
                    e = lane[4] = t2
                    self.tails += 1
                if canhit and low <= e < q and q - e <= max_dist:
                    check = cut is None or k < cut
                    touched |= self.win and check and e < self.d0
                    lane[5] = self._candidate(q, e, low, check)
                    if seq[e] == seq[q]:
                        hits.append(k)
            self.hist_windows += touched
            if cut is not None and (not hits or hits[0] >= cut) and all(
                    lane[0] for lane in lanes[:cut]):
                self.win = False        # the kernel goes on with the row
                self.left += 1
            last = hits[0] if hits else WARP - 1
            # commit lanes up to the first hit: the highest of each hash
            # group writes
            writer = {}
            for k in range(last + 1):
                if lanes[k][0]:
                    writer[lanes[k][3]] = k
                    if lower_of[k] is not None:
                        self.shared += 1
            if ht is not None and ht not in writer:
                tab[ht] = t2
            ht = None
            for h, k in writer.items():
                tab[h] = lanes[k][2]
            if hits:
                self.hits += 1
                self.ext = lanes[hits[0]][5]
                return lanes[hits[0]][2], lanes[hits[0]][4]
            if not all(lane[0] for lane in lanes):
                return None, None
            j0 += WARP


def encode_blocks_lockstep(src, lens, dict_bufs=None, dict_lens=None, *,
                           cap_n: int, acceleration: int = 1,
                           dict_stride: int = 3, max_dist: int = 65535):
    """`encode_blocks_plain` with B1's lockstep scan and parallel history
    pre-insert modelled lane by lane (for the tests). Returns the plain
    version's tensors and the `LockstepModel` with its counts."""
    model = LockstepModel()
    return (*_encode_batch(src, lens, dict_bufs, dict_lens, cap_n,
                           acceleration, dict_stride, max_dist, model),
            model)
