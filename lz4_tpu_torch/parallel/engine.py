"""Block-batch engine on one GPU: `TorchBackend`, the port's counterpart
of `lz4_tpu.parallel.engine.TpuBackend`.

The frame layer hands it whole lists of blocks; each list becomes one
padded batch and one kernel launch (B1 to compress, B2 to decompress),
with one block per CTA or warp. Every table the kernels use is fresh per
block, so a batch of any size gives every block the same result, and
there is no fixed dispatch width to pad to.

Blocks above the 64 KB tier are encoded as linked 64 KB segments (each
sees the 64 KB before it as history) and folded back into one LZ4 block
by `merge_segment_streams`: each segment's trailing literal-only
sequence is merged into the next segment's first sequence. Match offsets
are plain distances and stay valid across the merge.
"""
from __future__ import annotations

from lz4_tpu_torch.block.backend import BlockDecodeError
from lz4_tpu_torch.block.batch import (DICT_CAP, pack_blocks,
                                       resolve_device, to_device_batch)
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.encode_cuda import encode_blocks

SEG = 65536


def _pad_cap(n: int, floor: int = 65536) -> int:
    """Round a capacity up to the standard frame block tiers (64 KB,
    256 KB, 1 MB, 4 MB, ...)."""
    cap = floor
    while cap < n:
        cap *= 4
    return cap


def _ext_len(v: int) -> int:
    return 0 if v < 15 else 1 + (v - 15) // 255


def _lit_header(L: int, matnib: int) -> bytes:
    tok = (min(15, L) << 4) | matnib
    out = bytes([tok])
    if L >= 15:
        rem = L - 15
        out += b"\xff" * (rem // 255) + bytes([rem % 255])
    return out


def merge_segment_streams(block_src: bytes, streams, trailings) -> bytes:
    """Merge per-64KB-segment sequence streams into one LZ4 block
    stream. trailings[k] = the final literal-run length the encoder
    reported for segment k."""
    out = bytearray()
    carry = 0                  # source bytes pending as literals
    pos = 0                    # current segment start within block_src
    n = len(block_src)
    for s, fl in zip(streams, trailings):
        fl = int(fl)
        tail_len = 1 + _ext_len(fl) + fl
        body = s[: len(s) - tail_len]
        seg_len = min(SEG, n - pos)
        if not body:
            carry += fl        # whole segment is literals: keep pending
        else:
            tok0 = body[0]
            matnib = tok0 & 15
            h = 1
            L1 = tok0 >> 4
            if L1 == 15:
                while True:
                    b = body[h]
                    h += 1
                    L1 += b
                    if b != 255:
                        break
            newL = carry + L1
            out += _lit_header(newL, matnib)
            out += block_src[pos - carry: pos + L1]
            out += body[h + L1:]
            carry = fl
        pos += seg_len
    out += _lit_header(carry, 0)
    if carry:
        out += block_src[n - carry:]
    return bytes(out)


class TorchBackend:
    """BlockBackend (lz4_tpu_torch.block.backend protocol) running block
    batches through kernels B1 and B2 on `device` (the GPU when None; it
    raises where there is none). On a CPU device the same calls run the
    kernels' plain PyTorch versions. The fast tier only: levels >= 2
    raise NotImplementedError."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _encode(self, blocks, dict_prefixes, *, cap_n, has_dict,
                acceleration, max_dist):
        """One launch over the padded batch; returns (list[bytes]
        streams, list[int] trailing literal runs)."""
        arrays = pack_blocks(blocks, dict_prefixes, cap=cap_n,
                             with_dict=has_dict)
        out, csizes, trailing = encode_blocks(
            *to_device_batch(*arrays, device=self.device), cap_n=cap_n,
            acceleration=acceleration, max_dist=max_dist)
        out = out.cpu().numpy()
        csizes = csizes.cpu().tolist()
        return ([out[i, : csizes[i]].tobytes() for i in range(len(blocks))],
                trailing.cpu().tolist())

    def _compress_big_batch(self, blocks, dict_prefixes, *, acceleration,
                            max_dist):
        """Blocks above the 64 KB tier: linked 64 KB segments in one
        launch, then the segment seams folded host-side."""
        seg_blocks, seg_dicts, counts = [], [], []
        for bi, b in enumerate(blocks):
            d0 = dict_prefixes[bi] if dict_prefixes else None
            m = 0
            for s in range(0, len(b), SEG):
                seg_blocks.append(b[s: s + SEG])
                if s == 0:
                    hist = bytes(d0)[-DICT_CAP:] if d0 else b""
                else:
                    hist = b[max(0, s - DICT_CAP): s]
                seg_dicts.append(hist or None)
                m += 1
            counts.append(m)
        comp, trail = self._encode(seg_blocks, seg_dicts, cap_n=SEG,
                                   has_dict=True, acceleration=acceleration,
                                   max_dist=max_dist)
        results, idx = [], 0
        for b, m in zip(blocks, counts):
            results.append(merge_segment_streams(
                b, comp[idx: idx + m], trail[idx: idx + m]))
            idx += m
        return results

    def compress_batch(self, blocks, *, level=0, acceleration=1,
                       dict_prefixes=None, favor_dec_speed=False,
                       max_dist=65535):
        if not blocks:
            return []
        if level >= 2:
            raise NotImplementedError(
                f"lz4_tpu_torch: level {level} is an HC level, which is not "
                "ported yet (ROADMAP item A8); use level <= 1")
        mx = max(len(b) for b in blocks)
        if mx > SEG:
            return self._compress_big_batch(
                blocks, dict_prefixes, acceleration=acceleration,
                max_dist=max_dist)
        has_dict = dict_prefixes is not None and any(
            d for d in dict_prefixes)
        out, _ = self._encode(blocks, dict_prefixes, cap_n=_pad_cap(mx),
                              has_dict=has_dict, acceleration=acceleration,
                              max_dist=max_dist)
        return out

    def decompress_batch(self, blocks, max_outs, *, dict_prefixes=None):
        if not blocks:
            return []
        has_dict = dict_prefixes is not None and any(
            d for d in dict_prefixes)
        # one output tier covers the batch; reads past the longest stream
        # read 0, so the input row needs no compress_bound padding
        cap_out = _pad_cap(max(max_outs))
        cap_in = max(1, max(len(b) for b in blocks))
        arrays = pack_blocks(blocks, dict_prefixes, cap=cap_in,
                             with_dict=has_dict)
        out, olens, errs = decode_blocks(
            *to_device_batch(*arrays, device=self.device), cap_out=cap_out)
        errs = errs.cpu().tolist()
        olens = olens.cpu().tolist()
        out = out.cpu().numpy()
        res = []
        for i in range(len(blocks)):
            if errs[i]:
                raise BlockDecodeError(f"malformed block {i}")
            if olens[i] > max_outs[i]:
                raise BlockDecodeError(
                    f"block {i} decodes to {olens[i]} > cap {max_outs[i]}")
            res.append(out[i, : olens[i]].tobytes())
        return res


def install_torch_backend(device=None) -> TorchBackend:
    """Make a TorchBackend the process-wide default block backend."""
    from lz4_tpu_torch.block.backend import set_default_backend
    be = TorchBackend(device)
    set_default_backend(be)
    return be
