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

import torch

from lz4_tpu_torch.block.batch import DICT_CAP, to_device_batch
from lz4_tpu_torch.constants import MINMATCH

#: kernel launches made by `decode_blocks` (and nowhere else)
launches = 0


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
    if comp.device.type == "cpu":
        return decode_blocks_plain(comp, comp_lens, dict_bufs, dict_lens,
                                   cap_out=cap_out, loose=loose)
    if comp.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {comp.device}")
    B, cap_in = comp.shape
    out = torch.empty((B, cap_out), dtype=torch.uint8, device=comp.device)
    olen = torch.empty(B, dtype=torch.int32, device=comp.device)
    err = torch.empty(B, dtype=torch.int32, device=comp.device)
    if B == 0:
        return out, olen, err
    from lz4_tpu_torch import _build
    fn = _build.load("decode_serial")
    has_dict = dict_bufs is not None
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        rc = fn(comp.data_ptr(), comp_lens.data_ptr(),
                dict_bufs.data_ptr() if has_dict else None,
                dict_lens.data_ptr() if has_dict else None,
                out.data_ptr(), olen.data_ptr(), err.data_ptr(),
                B, cap_in, cap_out, int(has_dict), int(bool(loose)), stream)
    if rc != 0:
        raise RuntimeError(f"B2 decode_serial launch failed: CUDA error {rc}")
    launches += 1
    return out, olen, err


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
