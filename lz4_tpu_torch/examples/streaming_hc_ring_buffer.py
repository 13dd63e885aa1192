"""HC streaming over a ring buffer — the streamingHC_ringBuffer.c analog.

Same bounded-memory contract as the fast-tier ring example, but blocks
go through the high-compression tier (level 9): streaming HC carries
its dictionary across calls exactly like LZ4_compress_HC_continue
(lz4hc.c:1722-1734).

    python -m lz4_tpu_torch.examples.streaming_hc_ring_buffer
"""
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.constants import LZ4_DISTANCE_MAX
from lz4_tpu_torch.utils.datagen import gen_text

MSG_MAX = 8192
RING_SIZE = LZ4_DISTANCE_MAX + MSG_MAX


def main():
    backend = HostBackend()
    messages = [gen_text(1024 + 101 * i, seed=100 + i) for i in range(24)]

    ring = bytearray()
    blocks = []
    for msg in messages:
        prefix = bytes(ring[-LZ4_DISTANCE_MAX:])
        blocks.append(backend.compress_batch(
            [msg], level=9, dict_prefixes=[prefix or None])[0])
        ring += msg
        if len(ring) > RING_SIZE:
            del ring[: len(ring) - RING_SIZE]

    ring = bytearray()
    out = []
    for comp in blocks:
        prefix = bytes(ring[-LZ4_DISTANCE_MAX:])
        dec = backend.decompress_batch(
            [comp], [MSG_MAX], dict_prefixes=[prefix or None])[0]
        out.append(dec)
        ring += dec
        if len(ring) > RING_SIZE:
            del ring[: len(ring) - RING_SIZE]

    assert out == messages
    total, ctotal = sum(map(len, messages)), sum(map(len, blocks))
    one_shot = sum(len(b) for b in HostBackend().compress_batch(
        messages, level=9))
    print(f"HC streaming: {total} -> {ctotal} bytes "
          f"(vs {one_shot} without shared history): OK")


if __name__ == "__main__":
    main()
