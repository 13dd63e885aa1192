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
table in shared memory, its other warps writing the output the parse
warp hands them; a larger call runs one warp a block, up to 8 an SM, with
the tables in device memory. Nothing else picks the path, and the bytes
are the same on both.
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
                dict_stride: int, max_dist: int, model=None):
    """One block: buf = [d0 history bytes | block row | zeros]. With a
    `LockstepModel`, its history pre-insert and scan replace the serial
    ones."""
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
        ml = (p - p2) + MINMATCH + _fwd_count(
            buf, p + MINMATCH, cand + MINMATCH, matchlimit - (p + MINMATCH))
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
                                    dict_stride, max_dist, model)
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
    their candidate) and `hits`."""

    def __init__(self):
        self.windows = self.shared = self.hits = self.tails = 0

    @staticmethod
    def preinsert(tab, hsh, low, d0, dict_stride):
        for q in reversed(range(low, d0, dict_stride)):
            tab[hsh[q]] = max(tab[hsh[q]], q)

    def scan(self, seq, hsh, tab, p, accel0, low, mflimit, matchlimit,
             max_dist, tail=None):
        ht, t2 = tail if tail is not None else (None, None)
        wp, j0 = p, accel0
        while True:
            self.windows += 1
            positions, wp = window_positions(wp, j0)
            lanes = []
            for k, pos in enumerate(positions):
                active = canhit = pos <= mflimit
                q = pos
                if k & 1:           # sp1: inserts whenever its sp ran
                    active = pos - ((j0 + k - 1) >> SKIP_TRIGGER) <= mflimit
                    q = min(pos, matchlimit)
                h = hsh[q] if active else 0x10000 + k
                lanes.append([active, canhit, q, h,
                              tab[h] if active else 0])
            # __match_any_sync, masked to lower lanes
            last_of = {}
            lower_of = []
            for k, (_, _, q, h, _) in enumerate(lanes):
                lower_of.append(last_of.get(h))
                last_of[h] = k
            hits = []
            for k, lane in enumerate(lanes):
                active, canhit, q, h, e = lane
                if lower_of[k] is not None:
                    e = lane[4] = lanes[lower_of[k]][2]
                elif active and h == ht:
                    e = lane[4] = t2
                    self.tails += 1
                if (canhit and low <= e < q and q - e <= max_dist
                        and seq[e] == seq[q]):
                    hits.append(k)
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
