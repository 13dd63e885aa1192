"""Block-batch engine on one GPU: `TorchBackend`, the port's counterpart
of `lz4_tpu.parallel.engine.TpuBackend`.

The frame layer hands it whole lists of blocks; each list becomes one
padded batch and one kernel launch, with one block per CTA, warp or
thread. Every table the kernels use is fresh per block, so a batch of any
size gives every block the same result, and there is no fixed dispatch
width to pad to. The routes follow `TpuBackend`'s, in its order:

- decompress, no dict and every output <= 64 KB (`wave_decode`): the
  host C wave splitter, then one B3 launch. A stream the splitter
  rejects sends the batch to `HostBackend`, which raises the canonical
  error (counted in `host_fallbacks`). Then the size gates: a batch
  whose blocks and outputs are all under `min_device_size`, outputs over
  `max_device_decode_size`, and outputs over 256 KB unless `decode_dest`
  is "device" go to `HostBackend`. Everything else: B2. (With "device",
  `TpuBackend` decodes the tiers over 256 KB as linked 64 KB piece
  waves; the port keeps B2 for them until that route is ported. The
  bytes are the same.)
- compress, `max_dist` < 65535: level < 2, no dict and every block <=
  64 KB run B4 plus the host C emitter (`wave_encode`; B1 with its cap
  when it is off); anything else goes to `HostBackend`, which raises for
  HC levels.
- compress, HC levels: levels 3-9 of a no-dict batch whose largest block
  lies in [`min_device_size`, 64 KB], without `favor_dec_speed`, run on
  B5, one launch per batch (counted in `hc_encoded`). Level 2 runs the
  sort/scan encoder (`block/encode_sortscan.py`, torch ops: 8 candidates,
  lazy arbitration) whatever `favor_dec_speed` is, dict batches and
  blocks over 64 KB included (counted in `device_hc_encoded`). Levels
  10-12 and the other level 3-9 batches go to `HostBackend`.
- compress, level <= 1: B1. Level <= 2 batches whose largest block is
  under `min_device_size` or over `max_device_size` go to `HostBackend`.

Blocks above the 64 KB tier are encoded as linked 64 KB segments (each
sees the 64 KB before it as history) and folded back into one LZ4 block
by `merge_segment_streams`: each segment's trailing literal-only
sequence is merged into the next segment's first sequence. Match offsets
are plain distances and stay valid across the merge.
"""
from __future__ import annotations

from lz4_tpu_torch.block import encode_sortscan
from lz4_tpu_torch.block.backend import BlockDecodeError, HostBackend
from lz4_tpu_torch.block.batch import (DICT_CAP, pack_blocks,
                                       resolve_device, to_device_batch)
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.decode_wave import wave_decode_batch
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc
from lz4_tpu_torch.block.encode_wave import HASH_BITS, encode_wave_batch

SEG = 65536
#: HC levels served by kernel B5 (`lz4_tpu` engine.py:576)
HC_DEVICE_LEVELS = range(3, 10)
#: level 2's candidate count on the sort/scan encoder (engine.py:453)
HC_N_CAND = 8
#: outputs above this tier decode on the host unless decode_dest is
#: "device" (engine.py:826)
DEST_TIER = 1 << 18


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
    batches through kernels B1-B5 and the sort/scan encoder on `device`
    (the GPU when None; it raises where there is none). On a CPU device
    the same calls run the kernels' plain PyTorch versions. The routes
    are the module docstring's; `min_device_size`, `max_device_size` and
    `max_device_decode_size` default as in `TpuBackend`.

    `wave_decode` and `wave_encode` switch the wave routes; `decode_dest`
    ("auto" or "device") sends decodes of outputs over 256 KB to the host
    or to B2. `wave_decoded`, `wave_encoded`, `hc_encoded` (B5) and
    `device_hc_encoded` (level 2) count the batches each route served;
    `host_fallbacks` counts the batches the wave splitter rejected."""

    wave_decode = True
    wave_encode = True
    decode_dest = "auto"

    def __init__(self, device=None, min_device_size: int = 4096,
                 max_device_size: int = 4 * 1024 * 1024,
                 max_device_decode_size: int = 4 * 1024 * 1024):
        self.device = resolve_device(device)
        self.min_device_size = min_device_size
        self.max_device_size = max_device_size
        self.max_device_decode_size = max_device_decode_size
        self.wave_decoded = 0
        self.wave_encoded = 0
        self.hc_encoded = 0
        self.device_hc_encoded = 0
        self.host_fallbacks = 0

    def _encode(self, blocks, dict_prefixes, *, cap_n, has_dict,
                acceleration, max_dist, level=1):
        """One padded batch on the fast-tier encoder (B1), or at level 2
        on the sort/scan encoder; returns (list[bytes] streams, list[int]
        trailing literal runs)."""
        arrays = to_device_batch(*pack_blocks(
            blocks, dict_prefixes, cap=cap_n, with_dict=has_dict),
            device=self.device)
        if level == 2:
            out, csizes, trailing = encode_sortscan.encode_blocks(
                *arrays, cap_n=cap_n, has_dict=has_dict,
                n_cand=HC_N_CAND, lazy=True)
        else:
            out, csizes, trailing = encode_blocks(
                *arrays, cap_n=cap_n, acceleration=acceleration,
                max_dist=max_dist)
        out = out.cpu().numpy()
        csizes = csizes.cpu().tolist()
        return ([out[i, : csizes[i]].tobytes() for i in range(len(blocks))],
                trailing.cpu().tolist())

    def _compress_big_batch(self, blocks, dict_prefixes, *, acceleration,
                            max_dist, level=1):
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
                                   max_dist=max_dist, level=level)
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
        if max_dist < 65535:
            return self._compress_maxd(blocks, level=level,
                                       acceleration=acceleration,
                                       dict_prefixes=dict_prefixes,
                                       favor_dec_speed=favor_dec_speed,
                                       max_dist=max_dist)
        mx = max(len(b) for b in blocks)
        has_dict = dict_prefixes is not None and any(
            d for d in dict_prefixes)
        if (level in HC_DEVICE_LEVELS and not has_dict
                and self.min_device_size <= mx <= SEG
                and not favor_dec_speed):
            self.hc_encoded += 1
            return self._compress_hc(blocks, level=level)
        # level 2 runs on the sort/scan encoder whatever favor_dec_speed
        # is (lz4_tpu engine.py:641-678); the other HC cases and blocks
        # outside the size gate go to the host tier
        if level > 2 or not (self.min_device_size <= mx
                             <= self.max_device_size):
            return HostBackend().compress_batch(
                blocks, level=level, acceleration=acceleration,
                dict_prefixes=dict_prefixes,
                favor_dec_speed=favor_dec_speed)
        if level == 2:
            self.device_hc_encoded += 1
        if mx > SEG:
            return self._compress_big_batch(
                blocks, dict_prefixes, acceleration=acceleration,
                max_dist=max_dist, level=level)
        out, _ = self._encode(blocks, dict_prefixes, cap_n=_pad_cap(mx),
                              has_dict=has_dict, acceleration=acceleration,
                              max_dist=max_dist, level=level)
        return out

    def _compress_hc(self, blocks, *, level):
        """No-dict HC batch of blocks <= 64 KB: one B5 launch."""
        src, lens, _, _ = pack_blocks(blocks, cap=SEG)
        out, csizes, _ = encode_blocks_hc(
            *to_device_batch(src, lens, device=self.device)[:2], cap_n=SEG,
            level=level)
        out = out.cpu().numpy()
        csizes = csizes.cpu().tolist()
        return [out[i, : csizes[i]].tobytes() for i in range(len(blocks))]

    def _compress_maxd(self, blocks, *, level, acceleration, dict_prefixes,
                       favor_dec_speed, max_dist):
        """Distance-capped compression (lz4_tpu engine.py:608-636)."""
        if (level < 2 and not (dict_prefixes and any(dict_prefixes))
                and max(len(b) for b in blocks) <= SEG):
            if self.wave_encode:
                self.wave_encoded += 1
                hb = 9 if acceleration > 1 else HASH_BITS
                return encode_wave_batch(blocks, max_dist=max_dist,
                                         hash_bits=hb, device=self.device)
            out, _ = self._encode(blocks, None,
                                  cap_n=_pad_cap(max(len(b) for b in blocks)),
                                  has_dict=False, acceleration=acceleration,
                                  max_dist=max_dist)
            return out
        return HostBackend().compress_batch(
            blocks, level=level, acceleration=acceleration,
            dict_prefixes=dict_prefixes, favor_dec_speed=favor_dec_speed,
            max_dist=max_dist)

    def decompress_batch_wave(self, blocks, max_outs):
        """No-dict <= 64 KB batch on the wave tier (lz4_tpu engine.py:
        774-803): one C `wave_split_batch` call, then one B3 launch.
        Returns None when the splitter rejects a stream."""
        from lz4_tpu_torch.native import blockcodec
        # shape family {4, 16, 64} pieces, as in the reference
        need = -(-max(max_outs) // 1024)
        NP = 4
        while NP < need:
            NP *= 4
        r = blockcodec.wave_split_batch(blocks, max_pieces=NP,
                                        out_caps=list(max_outs))
        if r is None:
            return None
        arenas, out_lens = r
        return wave_decode_batch(arenas, out_lens, device=self.device)

    def decompress_batch(self, blocks, max_outs, *, dict_prefixes=None):
        if not blocks:
            return []
        has_dict = dict_prefixes is not None and any(
            d for d in dict_prefixes)
        mo = max(max_outs)
        if self.wave_decode and not has_dict and mo <= SEG:
            out = self.decompress_batch_wave(blocks, max_outs)
            if out is not None:
                self.wave_decoded += 1
                return out
            # the strict host decoder raises the canonical error
            self.host_fallbacks += 1
            return HostBackend().decompress_batch(blocks, max_outs)
        # the size gates of lz4_tpu engine.py:816-837, in its order
        if (max(len(b) for b in blocks) < self.min_device_size
                and mo < self.min_device_size) \
                or mo > self.max_device_decode_size \
                or (mo > DEST_TIER and self.decode_dest != "device"):
            return HostBackend().decompress_batch(
                blocks, max_outs, dict_prefixes=dict_prefixes)
        # one output tier covers the batch; reads past the longest stream
        # read 0, so the input row needs no compress_bound padding (a whole
        # number of 4-byte words, so B2 reads the rows a word at a time)
        cap_out = _pad_cap(mo)
        cap_in = -(-max(1, max(len(b) for b in blocks)) // 4) * 4
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
