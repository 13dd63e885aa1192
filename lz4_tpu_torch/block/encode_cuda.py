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
"""
from __future__ import annotations

import torch

from lz4_tpu_torch.block.batch import DICT_CAP, to_device_batch
from lz4_tpu_torch.constants import (ACCELERATION_MAX, LASTLITERALS,
                                     MFLIMIT, MINMATCH, compress_bound)

HASH_LOG = 16
HASH_MUL = 2654435761          # Knuth multiplier
SKIP_TRIGGER = 6
MAX_CAP_N = 65536

#: kernel launches made by `encode_blocks` (and nowhere else)
launches = 0


def _check(acceleration, dict_stride, max_dist, cap_n):
    if not 0 <= cap_n <= MAX_CAP_N:
        raise ValueError(f"cap_n must be in [0, {MAX_CAP_N}], got {cap_n}")
    if dict_stride < 1:
        raise ValueError(f"dict_stride must be >= 1, got {dict_stride}")
    if not 1 <= max_dist <= 65535:
        raise ValueError(f"max_dist must be in [1, 65535], got {max_dist}")
    # the reference acceleration range (lz4.c:52-58)
    return min(max(int(acceleration), 1), ACCELERATION_MAX)


def encode_blocks(src, lens, dict_bufs=None, dict_lens=None, *, cap_n: int,
                  acceleration: int = 1, dict_stride: int = 3,
                  max_dist: int = 65535):
    """Encode a batch of blocks (see the module docstring).

    Tensors stay on their device: CPU tensors run the plain version, CUDA
    tensors launch B1. numpy arrays go to the GPU (raising where there is
    none).
    """
    global launches
    accel = _check(acceleration, dict_stride, max_dist, cap_n)
    device = src.device if isinstance(src, torch.Tensor) else None
    src, lens, dict_bufs, dict_lens = to_device_batch(
        src, lens, dict_bufs, dict_lens, device=device)
    if src.shape[1] != cap_n:
        raise ValueError(f"src must be uint8[B, {cap_n}], got "
                         f"{tuple(src.shape)}")
    if src.device.type == "cpu":
        return encode_blocks_plain(src, lens, dict_bufs, dict_lens,
                                   cap_n=cap_n, acceleration=accel,
                                   dict_stride=dict_stride,
                                   max_dist=max_dist)
    if src.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {src.device}")
    B = src.shape[0]
    bound = compress_bound(cap_n)
    out = torch.empty((B, bound), dtype=torch.uint8, device=src.device)
    csizes = torch.empty(B, dtype=torch.int32, device=src.device)
    trailing = torch.empty(B, dtype=torch.int32, device=src.device)
    if B == 0:
        return out, csizes, trailing
    from lz4_tpu_torch import _build
    fn = _build.load("encode_serial")
    has_dict = dict_bufs is not None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), lens.data_ptr(),
                dict_bufs.data_ptr() if has_dict else None,
                dict_lens.data_ptr() if has_dict else None,
                out.data_ptr(), csizes.data_ptr(), trailing.data_ptr(),
                B, cap_n, bound, int(has_dict), accel, dict_stride,
                max_dist, stream)
    if rc != 0:
        raise RuntimeError(f"B1 encode_serial launch failed: CUDA error {rc}")
    launches += 1
    return out, csizes, trailing


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


def _encode_one(buf: bytes, n: int, d0: int, low: int, accel0: int,
                dict_stride: int, max_dist: int):
    """One block: buf = [d0 history bytes | block row | zeros]."""
    seq, hsh = _words_and_hashes(buf)
    tab = [0] * (1 << HASH_LOG)
    mflimit = d0 + n - MFLIMIT
    matchlimit = d0 + n - LASTLITERALS

    for q in range(low, d0, dict_stride):      # history pre-insert
        tab[hsh[q]] = q

    def scan(sp):
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

    out = bytearray()
    anchor = d0
    p, cand = scan(d0)
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
        t2 = p2 + ml - 2                         # tail insert
        tab[hsh[t2]] = t2
        anchor = p2 + ml
        p, cand = scan(anchor)
    litlen = max(d0 + n - anchor, 0)
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        _put_len(out, litlen - 15)
    out += buf[anchor: anchor + litlen]
    return out, litlen


def encode_blocks_plain(src, lens, dict_bufs=None, dict_lens=None, *,
                        cap_n: int, acceleration: int = 1,
                        dict_stride: int = 3, max_dist: int = 65535):
    """Plain PyTorch version of B1 on CPU tensors: the kernel's greedy
    parse step for step, in Python over each block's bytes, written into
    tensors of the kernel's contract."""
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
                                    dict_stride, max_dist)
        out[b, : len(stream)] = torch.frombuffer(stream, dtype=torch.uint8)
        csizes[b] = len(stream)
        trailing[b] = trail
    return out, csizes, trailing
