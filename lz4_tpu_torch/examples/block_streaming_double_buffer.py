"""Linked-block streaming with a rolling history window — the
examples/blockStreaming_doubleBuffer.c analog. Each block may reference
the previous block's bytes (the 64 KB window), halving the price of
repeated content across block boundaries.

    python -m lz4_tpu_torch.examples.block_streaming_double_buffer
"""
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.constants import LZ4_DISTANCE_MAX
from lz4_tpu_torch.utils.datagen import gen_buffer

BLOCK = 8 * 1024


def main():
    data = gen_buffer(16 * BLOCK, match_prob=0.8, seed=1)
    be = HostBackend()

    # compress with a rolling window
    history = b""
    frames = []
    for i in range(0, len(data), BLOCK):
        raw = data[i: i + BLOCK]
        comp = be.compress_batch([raw], dict_prefixes=[history or None])[0]
        frames.append(comp)
        history = (history + raw)[-LZ4_DISTANCE_MAX:]

    # decompress with the same rolling window
    history = b""
    out = []
    for comp in frames:
        raw = be.decompress_batch([comp], [BLOCK],
                                  dict_prefixes=[history or None])[0]
        out.append(raw)
        history = (history + raw)[-LZ4_DISTANCE_MAX:]

    assert b"".join(out) == data
    linked = sum(map(len, frames))
    indep = sum(len(be.compress_batch([data[i:i + BLOCK]])[0])
                for i in range(0, len(data), BLOCK))
    print(f"linked {linked} vs independent {indep} bytes — "
          f"window saves {100 * (indep - linked) / indep:.1f}%")


if __name__ == "__main__":
    main()
