"""Ring-buffer block streaming — the blockStreaming_ringBuffer.c analog.

A bounded ring holds the decoder's working memory: the compressor emits
blocks whose history is the ring contents behind the write cursor, and
the decompressor replays them into an identically-sized ring — total
memory stays O(ring), independent of stream length (the reference's
LZ4_decoderRingBufferSize contract, lz4.h:479-530).

    python -m lz4_tpu_torch.examples.block_streaming_ring_buffer
"""
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.constants import LZ4_DISTANCE_MAX
from lz4_tpu_torch.utils.datagen import gen_text

MSG_MAX = 4096
RING_SIZE = LZ4_DISTANCE_MAX + MSG_MAX      # decoder ring contract


def main():
    backend = HostBackend()
    messages = [gen_text(512 + 37 * i, seed=i) for i in range(40)]

    # --- compress: ring holds the last RING_SIZE bytes of history ----
    ring = bytearray()
    blocks = []
    for msg in messages:
        prefix = bytes(ring[-LZ4_DISTANCE_MAX:])
        blocks.append(backend.compress_batch(
            [msg], dict_prefixes=[prefix or None])[0])
        ring += msg
        if len(ring) > RING_SIZE:
            del ring[: len(ring) - RING_SIZE]

    # --- decompress into an equally bounded ring ---------------------
    ring = bytearray()
    out = []
    for comp, msg in zip(blocks, messages):
        prefix = bytes(ring[-LZ4_DISTANCE_MAX:])
        dec = backend.decompress_batch(
            [comp], [MSG_MAX], dict_prefixes=[prefix or None])[0]
        out.append(dec)
        ring += dec
        if len(ring) > RING_SIZE:
            del ring[: len(ring) - RING_SIZE]

    assert out == messages
    total = sum(map(len, messages))
    ctotal = sum(map(len, blocks))
    print(f"{len(messages)} messages, {total} -> {ctotal} bytes, "
          f"ring bounded at {RING_SIZE} bytes: OK")


if __name__ == "__main__":
    main()
