"""Batch frame surfaces over the wave tiers (the port's counterpart of
lz4_tpu/frame/batch.py).

The device's batch dimension is the frame axis: many frames encode and
decode abreast, one block stream per frame. Linked-block frames (-BD)
carry each frame's 64 KB history on the device between rounds
(`decode_wave.wave_decode_linked`); independent-block frames decode their
blocks as independent streams, all in one launch.

Two faults of the JAX surface are not copied. It decodes independent
frames as linked (lz4_tpu/frame/batch.py:135 with decode_wave.py:417), so
a malformed frame whose offsets cross a block boundary decodes silently;
here the splitter rejects such a block and the frame goes to the
sequential decoder, which raises. It also ignores `dict_id`; here a frame
with a dictionary ID is not wave-eligible. Frames that are not eligible
decode through `decompress_frame` on a `TorchBackend`, counted in
`sequential_fallbacks`.
"""
from __future__ import annotations

import struct

from lz4_tpu_torch.constants import BLOCK_UNCOMPRESSED_FLAG
from lz4_tpu_torch.frame.format import (FrameError, FrameInfo, header_size,
                                        parse_frame_header,
                                        write_frame_header)
from lz4_tpu_torch.frame.reader import decompress_frame
from lz4_tpu_torch.xxh32 import xxh32

#: the 64 KB block tier the wave kernels serve
BLOCK = 65536
#: frames per encode group: the linked history window follows the longest
#: block of a round's group, as in the JAX surface
GROUP = 128

#: frames decoded by the sequential decoder instead of the wave tier
sequential_fallbacks = 0


def _walk_frame(frame: bytes):
    """Parse the header and split the block payloads of one LZ4F frame.
    Returns (info, payloads, raw_flags, content_checksum_word)."""
    info, pos = parse_frame_header(frame[: header_size(frame)])
    payloads, raw_flags = [], []
    while True:
        if pos + 4 > len(frame):
            raise FrameError("frameDecoding_alreadyStarted",
                             "truncated frame")
        word = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if word == 0:
            break
        size = word & ~BLOCK_UNCOMPRESSED_FLAG
        if size > info.block_max_size:
            raise FrameError("maxBlockSize_invalid")
        if pos + size > len(frame):
            raise FrameError("frameDecoding_alreadyStarted",
                             "truncated block")
        payloads.append(frame[pos: pos + size])
        raw_flags.append(bool(word & BLOCK_UNCOMPRESSED_FLAG))
        pos += size
        if info.block_checksum:
            if pos + 4 > len(frame):
                raise FrameError("frameDecoding_alreadyStarted",
                                 "truncated block checksum")
            if xxh32(payloads[-1], 0) != struct.unpack_from("<I", frame,
                                                            pos)[0]:
                raise FrameError("blockChecksum_invalid")
            pos += 4
    csum = None
    if info.content_checksum:
        if pos + 4 > len(frame):
            raise FrameError("frameDecoding_alreadyStarted",
                             "truncated content checksum")
        csum = struct.unpack_from("<I", frame, pos)[0]
    return info, payloads, raw_flags, csum


def compress_frames_wave(datas: list[bytes], *, max_dist: int = 2048,
                         block_independent: bool = False,
                         content_checksum: bool = True,
                         device=None) -> list[bytes]:
    """Compress payloads into .lz4 frames on the wave encode tier: 64 KB
    blocks, offsets capped at max_dist. Linked (-BD) by default: each
    frame's blocks see its earlier bytes as history. Standard LZ4F
    output, byte-identical to the JAX surface's."""
    from lz4_tpu_torch.block.encode_wave import (encode_wave_batch,
                                                 encode_wave_linked)
    results: list[bytes] = []
    for g in range(0, len(datas), GROUP):
        grp = [bytes(d) for d in datas[g: g + GROUP]]
        streams_raw = [[d[i: i + BLOCK] for i in range(0, max(len(d), 1),
                                                       BLOCK)]
                       for d in grp]
        if block_independent:
            flat = encode_wave_batch([b for s in streams_raw for b in s],
                                     max_dist=max_dist, device=device)
            enc, k = [], 0
            for s in streams_raw:
                enc.append(flat[k: k + len(s)])
                k += len(s)
        else:
            enc = encode_wave_linked(streams_raw, max_dist=max_dist,
                                     device=device)
        info = FrameInfo(block_size_id=4,
                         block_independent=block_independent,
                         content_checksum=content_checksum)
        for d, raws, comps in zip(grp, streams_raw, enc):
            parts = [write_frame_header(info)]
            for raw, comp in zip(raws, comps):
                if len(comp) >= len(raw) and raw:
                    # a stored block beats expansion
                    parts += [struct.pack("<I", len(raw)
                                          | BLOCK_UNCOMPRESSED_FLAG), raw]
                else:
                    parts += [struct.pack("<I", len(comp)), comp]
            parts.append(b"\x00\x00\x00\x00")
            if content_checksum:
                parts.append(struct.pack("<I", xxh32(d, 0)))
            results.append(b"".join(parts))
    return results


def _decode_independent(streams: list[list[bytes]], device) -> list | None:
    """Every block of every frame as an independent stream, in one
    launch; None when the splitter rejects a block."""
    from lz4_tpu_torch.block.decode_wave import wave_decode_batch
    from lz4_tpu_torch.native import blockcodec
    flat = [b for s in streams for b in s]
    r = blockcodec.wave_split_batch(flat, max_pieces=BLOCK // 1024,
                                    out_caps=[BLOCK] * len(flat))
    if r is None:
        return None
    dec = wave_decode_batch(*r, device=device)
    outs, k = [], 0
    for s in streams:
        outs.append(b"".join(dec[k: k + len(s)]))
        k += len(s)
    return outs


def decompress_frames_wave(frames: list[bytes], *,
                           device=None) -> list[bytes]:
    """Decode .lz4 frames, on the wave tiers where a frame qualifies
    (64 KB blocks, all compressed, no dictionary ID); other frames, and
    groups the splitter rejects, decode one by one through the sequential
    decoder. Byte-exact and checksum-verified."""
    global sequential_fallbacks
    from lz4_tpu_torch.block.decode_wave import wave_decode_linked
    from lz4_tpu_torch.parallel.engine import TorchBackend
    be = TorchBackend(device)
    results: list[bytes | None] = [None] * len(frames)
    eligible = {True: [], False: []}      # block_independent -> indices
    metas = {}
    for i, f in enumerate(frames):
        try:
            info, payloads, raws, csum = _walk_frame(bytes(f))
        except FrameError:
            info = None
        if (info is None or info.frame_type != "lz4"
                or info.block_size_id != 4 or info.dict_id is not None
                or not payloads or any(raws)):
            sequential_fallbacks += 1
            results[i] = decompress_frame(frames[i], backend=be)
            continue
        metas[i] = (info, payloads, csum)
        eligible[info.block_independent].append(i)
    for independent, idxs in eligible.items():
        for g in range(0, len(idxs), GROUP):
            grp = idxs[g: g + GROUP]
            streams = [metas[i][1] for i in grp]
            if independent:
                outs = _decode_independent(streams, be.device)
            else:
                try:
                    outs = wave_decode_linked(streams, device=be.device)
                except ValueError:     # a block the splitter rejects
                    outs = None
            for k, i in enumerate(grp):
                if outs is None:
                    sequential_fallbacks += 1
                    results[i] = decompress_frame(frames[i], backend=be)
                    continue
                info, _, csum = metas[i]
                if csum is not None and xxh32(outs[k], 0) != csum:
                    raise FrameError("contentChecksum_invalid")
                if (info.content_size is not None
                        and len(outs[k]) != info.content_size):
                    raise FrameError("frameSize_wrong")
                results[i] = outs[k]
    return results  # type: ignore[return-value]
