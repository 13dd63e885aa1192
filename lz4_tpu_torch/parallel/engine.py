"""Block-batch engine: `TorchBackend`, the port's counterpart of
`lz4_tpu.parallel.engine.TpuBackend`, and the multi-GPU engine on
`torch.distributed` (`ShardedCodec`, `linked_encode_step`,
`wave_encode_sharded`), the counterparts of the JAX module's mesh engine.

The frame layer hands `TorchBackend` whole lists of blocks; each list
becomes one padded batch and one kernel launch, with one block per CTA,
warp or thread. Every table the kernels use is fresh per block, so a
batch of any size gives every block the same result, and there is no
fixed dispatch width to pad to. The routes follow `TpuBackend`'s, in its
order:

- decompress, no dict and every output <= 64 KB (`wave_decode`): the
  host C wave splitter, then one B3 launch. A stream the splitter
  rejects sends the batch to the host tier, which raises the canonical
  error (counted in `host_fallbacks`). Then the size gates: a batch
  whose blocks and outputs are all under `min_device_size`, and outputs
  over `max_device_decode_size`, go to the host tier. Outputs over
  256 KB go to the host tier unless `decode_dest` is "device" (and
  `serial_decode` is on): then each block is cut by the host C splitter
  into linked pieces of at most 64 KB of output, and B2 decodes them in
  waves, one launch a wave, piece k of every block in wave k, each
  block's last 64 KB of output carried on the device as the next wave's
  history (`_decompress_big_batch`). A stream the splitter rejects sends
  the batch to the host tier. Everything else: B2, or with
  `serial_decode` off the sort/scan decoder (`block/decode_sortscan.py`,
  torch ops, no kernel).
- compress, `max_dist` < 65535: level < 2, no dict and every block <=
  64 KB run B4 plus the host C emitter (`wave_encode`; B1 with its cap
  when it is off); anything else, and any batch under a `codec` or with
  `serial_encode` off, goes to the host tier, which raises for HC levels.
- compress, HC levels: levels 3-9 of a no-dict batch whose largest block
  lies in [`min_device_size`, 64 KB], without `favor_dec_speed`, run on
  B5, one launch per batch (counted in `hc_encoded`; not under a `codec`
  or with `serial_encode` off). Level 2 runs the sort/scan encoder
  (`block/encode_sortscan.py`, torch ops: 8 candidates, lazy
  arbitration) whatever `favor_dec_speed` is, dict batches and blocks
  over 64 KB included (counted in `device_hc_encoded`). Levels 10-12 and
  the other level 3-9 batches go to the host tier.
- compress, level <= 1: B1, or with `serial_encode` off the sort/scan
  encoder (2 candidates; the lighter graph from acceleration 4). Level
  <= 2 batches whose largest block is under `min_device_size` or over
  `max_device_size` go to the host tier.

Under a `ShardedCodec` the fast tier's B1, the <= 256 KB B2 decode and
the sort/scan codec run on each rank's contiguous shard of the batch,
and every rank gets the whole result back.

Blocks above the 64 KB tier are encoded as linked 64 KB segments (each
sees the 64 KB before it as history) and folded back into one LZ4 block
by `merge_segment_streams`: each segment's trailing literal-only
sequence is merged into the next segment's first sequence. Match offsets
are plain distances and stay valid across the merge.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from lz4_tpu_torch.block import decode_sortscan, encode_sortscan
from lz4_tpu_torch.block.backend import BlockDecodeError, HostBackend
from lz4_tpu_torch.block.batch import (DICT_CAP, pack_blocks,
                                       resolve_device, to_device_batch)
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.decode_wave import wave_decode_batch
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc
from lz4_tpu_torch.block.encode_wave import (HASH_BITS, encode_wave_batch,
                                             find_matches)
from lz4_tpu_torch.spans import span

SEG = 65536
#: HC levels served by kernel B5 (`lz4_tpu` engine.py:576)
HC_DEVICE_LEVELS = range(3, 10)
#: level 2's candidate count on the sort/scan encoder (engine.py:453)
HC_N_CAND = 8
#: outputs above this tier decode on the host unless decode_dest is
#: "device" (engine.py:826)
DEST_TIER = 1 << 18
#: the big-block splitter's piece slot: 64 KB of output plus the worst
#: case of its headers (engine.py:288), a whole number of 4-byte words
PIECE_CAP = 66816
#: most pieces of one block: 4 MB / 64 KB plus split slack (engine.py:289)
MAX_PIECES = 72


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




# --------------------------------------------------------------------------
# the multi-GPU engine on torch.distributed (lz4_tpu engine.py:47-197)
# --------------------------------------------------------------------------

def rank_device(rank: int, device=None) -> torch.device:
    """The device rank `rank` owns: `device` where the caller names one,
    else cuda:rank % device_count (raising where there is no GPU)."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(device)


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """all_gather of one rank's rows, concatenated in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _pad_rows(a, rows: int):
    """a (numpy or tensor, leading batch axis) padded with zero rows."""
    if a is None or a.shape[0] == rows:
        return a
    if isinstance(a, torch.Tensor):
        pad = torch.zeros((rows - a.shape[0], *a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, pad])
    pad = np.zeros((rows - a.shape[0], *a.shape[1:]), a.dtype)
    return np.concatenate([a, pad])


def _cut(out: torch.Tensor, csizes: torch.Tensor) -> list[bytes]:
    """Each result row of `out` (on the host) cut to its stream, as bytes
    that own their data."""
    with span("lz4t.to_bytes"):
        rows = out.numpy()
        return [rows[i, :n].tobytes() for i, n in enumerate(csizes.tolist())]


class ShardedCodec:
    """Batched block codec whose batch axis is split over the ranks of a
    process group (`ShardedCodec` of the JAX engine, whose batch axis is
    sharded over a mesh). Each rank owns one device and runs the codec on
    its contiguous shard of the batch; an all_gather hands every rank the
    whole result, as the gathered JAX arrays do. Every rank passes the
    same batch. The process group must be initialized (its backend NCCL
    for GPU tensors, gloo for CPU ones)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ShardedCodec needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.device = rank_device(self.rank, device)

    @property
    def n_devices(self) -> int:
        return self.world

    def map(self, fn, src, lens, dict_bufs=None, dict_lens=None):
        """fn over this rank's shard of the batch arrays (`to_device_batch`'s
        four, numpy or tensors), moved to this rank's device; fn returns a
        tuple of tensors with one row per block, gathered from every rank
        and cut back to the batch."""
        B = src.shape[0]
        b = -(-B // self.world)
        sl = slice(self.rank * b, (self.rank + 1) * b)
        local = [None if a is None else _pad_rows(a, b * self.world)[sl]
                 for a in (src, lens, dict_bufs, dict_lens)]
        outs = fn(*to_device_batch(*local, device=self.device))
        return tuple(_gather_rows(o, self.group)[:B] for o in outs)

    def encode(self, src, lens, dict_bufs, dict_lens, *, cap_n, has_dict,
               n_cand=1, lazy=False, lite=False):
        """The sort/scan encoder (`encode_sortscan.encode_blocks`) over
        the shards: (out, csizes, trailing) of the whole batch."""
        return self.map(functools.partial(
            encode_sortscan.encode_blocks, cap_n=cap_n, has_dict=has_dict,
            n_cand=n_cand, lazy=lazy, lite=lite), src, lens,
            dict_bufs if has_dict else None,
            dict_lens if has_dict else None)

    def decode(self, comp, lens, dict_bufs, dict_lens, *, cap_out,
               has_dict):
        """The sort/scan decoder (`decode_sortscan.decode_blocks`) over
        the shards: (out, out_lens, errs) of the whole batch."""
        return self.map(functools.partial(
            decode_sortscan.decode_blocks, cap_out=cap_out,
            has_dict=has_dict), comp, lens,
            dict_bufs if has_dict else None,
            dict_lens if has_dict else None)


def _row_tails(src: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each row's last DICT_CAP bytes up to lens, right-aligned with
    zeros before a shorter row (not the padded row's tail)."""
    b = src.shape[0]
    ext = torch.cat([torch.zeros((b, DICT_CAP), dtype=src.dtype,
                                 device=src.device), src], dim=1)
    idx = lens.long()[:, None] + torch.arange(DICT_CAP, device=src.device)
    return ext.gather(1, idx)


def linked_encode_step(src, lens, head_dict, head_dict_len, *, cap_n: int,
                       group=None, device=None):
    """One data-parallel linked-mode encode step over the process group
    (lz4_tpu engine.py:97-167).

    src uint8[B, cap_n]: B consecutive blocks of one stream, B divisible
    by the world size, rank r taking rows [r*B/W, (r+1)*B/W). Block i's
    history is block i-1's last 64 KB up to lens[i-1]; a shard's first
    block takes the previous rank's last tail (an all_gather of the last
    tails, of which each rank keeps rank - 1's: the JAX ring permute),
    and rank 0 takes head_dict uint8[1, 65536] (right-aligned) with
    head_dict_len int32[1]. Encodes on the sort/scan encoder (2
    candidates). Returns the whole batch's (comp uint8[B, bound], csizes
    int32[B], offsets int32[B], total int32[1]) on every rank: offsets is
    the exclusive prefix sum of the gathered sizes (the ordered frame
    assembly), total their all_reduce sum."""
    import torch.distributed as dist
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    dev = rank_device(rank, device)
    B = src.shape[0]
    if B % world:
        raise ValueError(f"{B} blocks do not split over {world} ranks")
    b = B // world
    sl = slice(rank * b, (rank + 1) * b)
    src_l, lens_l, _, _ = to_device_batch(src[sl], lens[sl], device=dev)
    hd, hl, _, _ = to_device_batch(head_dict, head_dict_len, device=dev)
    tails = _row_tails(src_l, lens_l)
    tail_lens = torch.clamp(lens_l, max=DICT_CAP)
    # every rank's last tail; rank r keeps rank r-1's
    last_tails = _gather_rows(tails[-1:], group)
    last_lens = _gather_rows(tail_lens[-1:], group)
    first = hd[0] if rank == 0 else last_tails[rank - 1]
    first_len = hl[0] if rank == 0 else last_lens[rank - 1]
    dict_bufs = torch.roll(tails, 1, dims=0)
    dict_lens = torch.roll(tail_lens, 1, dims=0)
    dict_bufs[0] = first
    dict_lens[0] = first_len
    comp, csizes, _ = encode_sortscan.encode_blocks(
        src_l, lens_l, dict_bufs, dict_lens, cap_n=cap_n, has_dict=True)
    all_sizes = _gather_rows(csizes, group)
    offsets = torch.cumsum(all_sizes, 0, dtype=torch.int32) - all_sizes
    total = csizes.sum(dtype=torch.int32).reshape(1)
    dist.all_reduce(total, group=group)
    return _gather_rows(comp, group), all_sizes, offsets, total


def wave_encode_sharded(inp, lens, *, max_dist: int, hash_bits: int,
                        group=None, device=None):
    """The wave match finder (B4, `encode_wave.find_matches`) over the
    process group (lz4_tpu engine.py:176-197): inp uint8[B, n_rows*4]
    with lens int32[B]; each rank runs B4 on its own contiguous shard,
    with no collective but the gather of the decisions int32[B, n_rows]
    that every rank gets back."""
    import torch.distributed as dist
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    dev = rank_device(rank, device)
    B = inp.shape[0]
    b = -(-B // world)
    inp, lens = _pad_rows(inp, b * world), _pad_rows(lens, b * world)
    sl = slice(rank * b, (rank + 1) * b)
    inp_l, lens_l, _, _ = to_device_batch(inp[sl], lens[sl], device=dev)
    dec = find_matches(inp_l, lens_l, max_dist=max_dist,
                       hash_bits=hash_bits)
    return _gather_rows(dec, group)[:B]


# --------------------------------------------------------------------------
# the backend
# --------------------------------------------------------------------------

class TorchBackend:
    """BlockBackend (lz4_tpu_torch.block.backend protocol) running block
    batches through kernels B1-B5 and the sort/scan codec on `device`
    (the GPU when None; it raises where there is none), or under `codec`
    (a `ShardedCodec`) on each rank's device and shard. On a CPU device
    the same calls run the kernels' plain PyTorch versions. The routes
    are the module docstring's; `min_device_size`, `max_device_size` and
    `max_device_decode_size` default as in `TpuBackend`. The host tier is
    one `HostBackend(nb_workers)`, made at first use.

    Plain attributes switch the routes: `wave_decode` and `wave_encode`
    the wave routes; `serial_decode` (`TpuBackend.pallas_decode`) B2,
    with the sort/scan decoder in its place when off; `serial_encode`
    (`TpuBackend.pallas_encode`) B1, B4 and B5, with the sort/scan
    encoder or the host tier in their place when off; `decode_dest`
    ("auto" or "device") sends decodes of outputs over 256 KB to the
    host or to B2's piece waves. `wave_decoded`, `wave_encoded`,
    `hc_encoded` (B5), `device_hc_encoded` (level 2), `piece_decoded`
    and `sortscan_decoded` count the batches each route served;
    `host_fallbacks` counts the batches a splitter rejected;
    `pinned_calls` counts the encode calls whose host bytes (the packed
    batch in, the results out) were staged in page-locked memory, which
    every B1, B5 and level-2 call on a GPU is, outside a codec."""

    wave_decode = True
    wave_encode = True
    serial_decode = True
    serial_encode = True
    decode_dest = "auto"

    def __init__(self, device=None, min_device_size: int = 4096,
                 max_device_size: int = 4 * 1024 * 1024,
                 max_device_decode_size: int = 4 * 1024 * 1024,
                 nb_workers: int = 0, codec: ShardedCodec | None = None):
        self.codec = codec
        self.device = codec.device if codec is not None and device is None \
            else resolve_device(device)
        self.min_device_size = min_device_size
        self.max_device_size = max_device_size
        self.max_device_decode_size = max_device_decode_size
        self.nb_workers = nb_workers
        self._host_be = None
        self.wave_decoded = 0
        self.wave_encoded = 0
        self.hc_encoded = 0
        self.device_hc_encoded = 0
        self.piece_decoded = 0
        self.sortscan_decoded = 0
        self.host_fallbacks = 0
        self.pinned_calls = 0

    def _host(self) -> HostBackend:
        """The host tier, made once (lz4_tpu engine.py:411-415)."""
        if self._host_be is None:
            self._host_be = HostBackend(nb_workers=self.nb_workers)
        return self._host_be

    def _stage(self) -> bool:
        """Whether this encode call stages its host bytes in page-locked
        memory (on a GPU, not under a codec), counted in `pinned_calls`."""
        staged = self.codec is None and self.device.type == "cuda"
        self.pinned_calls += staged
        return staged

    def _fetch(self, *results, staged):
        """A batch's result tensors on the host. Staged: non-blocking
        copies into page-locked tensors (reused through torch's caching
        host allocator) on the device's current stream, then one wait, on
        an event recorded after them (on an H100 host the stream's own
        synchronize left the host steps after it slower); else `.cpu()`
        each."""
        with span("lz4t.d2h"):
            if not staged:
                return [r.cpu() for r in results]
            host = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                    for r in results]
            for h, r in zip(host, results):
                h.copy_(r, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
            return host

    def _run(self, fn, *arrays):
        """fn on the batch arrays: on each rank's shard under a codec,
        else on this backend's device."""
        if self.codec is not None:
            return self.codec.map(fn, *arrays)
        return fn(*to_device_batch(*arrays, device=self.device))

    def _encode(self, blocks, dict_prefixes, *, cap_n, has_dict,
                acceleration, max_dist, level=1):
        """One padded batch on B5 at the HC levels, on the sort/scan
        encoder at level 2 or with `serial_encode` off, else on the
        fast-tier encoder (B1): pack, move, encode, bring home, cut.
        Returns (list[bytes] streams, list[int] trailing literal runs)."""
        staged = self._stage()
        arrays = pack_blocks(blocks, dict_prefixes, cap=cap_n,
                             with_dict=has_dict, pinned=staged)
        if level in HC_DEVICE_LEVELS:
            def fn(src, lens, *_):              # the HC route has no dict
                return encode_blocks_hc(src, lens, cap_n=cap_n, level=level)
        elif level == 2 or not self.serial_encode:
            fn = functools.partial(
                encode_sortscan.encode_blocks, cap_n=cap_n,
                has_dict=has_dict,
                n_cand=HC_N_CAND if level == 2 else 2, lazy=level == 2,
                lite=level != 2 and acceleration >= 4)
        else:
            fn = functools.partial(encode_blocks, cap_n=cap_n,
                                   acceleration=acceleration,
                                   max_dist=max_dist)
        out, csizes, trailing = self._fetch(*self._run(fn, *arrays),
                                            staged=staged)
        return _cut(out, csizes), trailing.tolist()

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
        with span("lz4t.compress_batch"):
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
                    and self.serial_encode and self.codec is None
                    and self.min_device_size <= mx <= SEG
                    and not favor_dec_speed):
                self.hc_encoded += 1
                return self._encode(blocks, None, cap_n=SEG, has_dict=False,
                                    acceleration=acceleration,
                                    max_dist=max_dist, level=level)[0]
            # level 2 runs on the sort/scan encoder whatever favor_dec_speed
            # is (lz4_tpu engine.py:641-678); the other HC cases and blocks
            # outside the size gate go to the host tier
            if level > 2 or not (self.min_device_size <= mx
                                 <= self.max_device_size):
                return self._host().compress_batch(
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

    def _compress_maxd(self, blocks, *, level, acceleration, dict_prefixes,
                       favor_dec_speed, max_dist):
        """Distance-capped compression (lz4_tpu engine.py:608-636)."""
        if (level < 2 and self.serial_encode and self.codec is None
                and not (dict_prefixes and any(dict_prefixes))
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
        return self._host().compress_batch(
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

    def _decompress_big_batch(self, blocks, max_outs, dict_prefixes):
        """Outputs over 256 KB with decode_dest "device" (lz4_tpu
        engine.py:680-754): the host C splitter cuts each block into
        linked pieces of at most 64 KB of output, then `_decode_pieces`
        runs B2 over them in waves. A stream the splitter rejects sends
        the batch to the host tier, which raises the canonical error."""
        from lz4_tpu_torch.native import blockcodec
        splits = []
        for blk, cap in zip(blocks, max_outs):
            r = blockcodec.split_stream(blk, piece_cap=PIECE_CAP,
                                        max_pieces=MAX_PIECES,
                                        out_limit=65536, out_cap=cap)
            if r is None:
                self.host_fallbacks += 1
                return self._host().decompress_batch(
                    blocks, max_outs, dict_prefixes=dict_prefixes)
            splits.append(r)
        self.piece_decoded += 1
        B = len(blocks)
        arenas, plens = pack_pieces(splits)
        waves = plens.shape[0]
        src0, lens0, hist, hlen = pack_blocks([b""] * B, dict_prefixes,
                                              cap=0, with_dict=True)
        _, _, hist, hlen = to_device_batch(src0, lens0, hist, hlen,
                                           device=self.device)
        comp, plens_d, _, _ = to_device_batch(
            arenas.reshape(waves * B, PIECE_CAP), plens.reshape(-1),
            device=self.device)
        outs, olens, errs = (t.numpy() for t in self._fetch(
            *_decode_pieces(comp, plens_d, hist, hlen, waves=waves),
            staged=False))
        res = []
        for i, (_, pl, po) in enumerate(splits):
            k = len(pl)
            if errs[:k, i].any() or (olens[:k, i] != po).any():
                raise BlockDecodeError(f"malformed block {i}")
            whole = b"".join(outs[j, i, : olens[j, i]].tobytes()
                             for j in range(k))
            if len(whole) > max_outs[i]:
                raise BlockDecodeError(
                    f"block {i} decodes to {len(whole)} > cap {max_outs[i]}")
            res.append(whole)
        return res

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
            return self._host().decompress_batch(blocks, max_outs)
        # the size gates of lz4_tpu engine.py:816-837, in its order
        if (max(len(b) for b in blocks) < self.min_device_size
                and mo < self.min_device_size) \
                or mo > self.max_device_decode_size:
            return self._host().decompress_batch(
                blocks, max_outs, dict_prefixes=dict_prefixes)
        if mo > DEST_TIER:
            if self.decode_dest == "device" and self.serial_decode:
                return self._decompress_big_batch(blocks, max_outs,
                                                  dict_prefixes)
            return self._host().decompress_batch(
                blocks, max_outs, dict_prefixes=dict_prefixes)
        # one output tier covers the batch; reads past the longest stream
        # read 0, so the input row needs no compress_bound padding (a whole
        # number of 4-byte words, so B2 reads the rows a word at a time)
        cap_out = _pad_cap(mo)
        cap_in = -(-max(1, max(len(b) for b in blocks)) // 4) * 4
        arrays = pack_blocks(blocks, dict_prefixes, cap=cap_in,
                             with_dict=has_dict)
        if self.serial_decode:
            fn = functools.partial(decode_blocks, cap_out=cap_out)
        else:
            self.sortscan_decoded += 1
            fn = functools.partial(decode_sortscan.decode_blocks,
                                   cap_out=cap_out, has_dict=has_dict)
        out, olens, errs = self._fetch(*self._run(fn, *arrays), staged=False)
        for i, (err, n) in enumerate(zip(errs.tolist(), olens.tolist())):
            if err:
                raise BlockDecodeError(f"malformed block {i}")
            if n > max_outs[i]:
                raise BlockDecodeError(
                    f"block {i} decodes to {n} > cap {max_outs[i]}")
        return _cut(out, olens)


def pack_pieces(splits):
    """The splitter's results of B blocks, (arena, piece_lens,
    piece_outs) each, as wave-major arrays: (arenas uint8[waves, B,
    PIECE_CAP], plens int32[waves, B]), wave k's pieces one contiguous
    [B, PIECE_CAP] batch, an empty slot of length 0. One H2D of these
    replaces the TPU relay's tight pack (lz4_tpu engine.py:716-722)."""
    waves = max(len(pl) for _, pl, _ in splits)
    arenas = np.zeros((waves, len(splits), PIECE_CAP), np.uint8)
    plens = np.zeros((waves, len(splits)), np.int32)
    for i, (arena, pl, _) in enumerate(splits):
        arenas[: len(pl), i] = arena
        plens[: len(pl), i] = pl
    return arenas, plens


def _decode_pieces(comp, plens, hist, hlen, *, waves: int):
    """B2 over linked piece waves (`_decode_pieces_scan` of lz4_tpu
    engine.py:292-331, its `lax.scan` as a loop of launches): comp
    uint8[waves*B, PIECE_CAP] holds wave k's pieces in rows [k*B,
    (k+1)*B), plens int32[waves*B] their lengths (0 for an empty slot),
    hist uint8[B, 65536] (right-aligned) with hlen int32[B] each block's
    history. Wave k is one B2 launch in `loose` mode with cap_out 64 KB;
    the next wave's history is the last 64 KB of history ++ output,
    gathered per row on the device (no host round trip between waves).
    An empty slot is neither an error nor output. Returns (outs
    uint8[waves, B, 65536], olens int32[waves, B], errs int32[waves, B])."""
    B = hist.shape[0]
    ar = torch.arange(DICT_CAP, device=comp.device)
    outs, olens, errs = [], [], []
    for k in range(waves):
        len_k = plens[k * B: (k + 1) * B]
        out, olen, err = decode_blocks(comp[k * B: (k + 1) * B], len_k,
                                       hist, hlen, cap_out=DICT_CAP,
                                       loose=True)
        empty = len_k == 0
        err = torch.where(empty, 0, err)
        olen = torch.where(empty, 0, olen)
        # a row in error carries any olen: keep its gather in range
        ol = olen.clamp(0, DICT_CAP).long()
        hist = torch.cat([hist, out], dim=1).gather(1, ol[:, None] + ar)
        hlen = torch.clamp(hlen + olen, max=DICT_CAP)
        outs.append(out)
        olens.append(olen)
        errs.append(err)
    return torch.stack(outs), torch.stack(olens), torch.stack(errs)


def install_torch_backend(device=None) -> TorchBackend:
    """Make a TorchBackend the process-wide default block backend."""
    from lz4_tpu_torch.block.backend import set_default_backend
    be = TorchBackend(device)
    set_default_backend(be)
    return be
