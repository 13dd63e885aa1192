"""Linked blocks through `TorchBackend.compress_batch` on the CPU: each
block given the bytes of its stream before it as its prefix, as the
frame writer hands the blocks of a linked frame to one call.

Every stream must decode, with its history in front of it, to exactly
its block, by a plain decoder written here from the block format (lz4
doc/lz4_Block_format.md), not the port's; a block given no prefix in the
same batch must stay independent. The plain version of B1 is no launch,
so the launch counters stay as they were.
"""
import numpy as np
import pytest
import torch

from lz4_tpu_torch.block import encode_cuda
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.probes import b1_split
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text


def _length(src: bytes, i: int, n: int) -> tuple[int, int]:
    """A length field whose nibble is `n`: (length, next index)."""
    if n == 15:
        while True:
            b = src[i]
            i += 1
            n += b
            if b != 255:
                break
    return n, i


def decode_linked(stream: bytes, history: bytes, n_out: int) -> bytes:
    """The n_out bytes that `stream` encodes with `history` before it.
    Raises ValueError on an offset of 0 or one that reaches before the
    history's first byte, on an output of another length, and where the
    last 5 bytes are not literals or the last match starts less than 12
    bytes before the end."""
    out = bytearray(history)
    base = len(out)
    i = 0
    last_match = None
    while True:
        tok = stream[i]
        lit, i = _length(stream, i + 1, tok >> 4)
        out += stream[i: i + lit]
        i += lit
        if i >= len(stream):
            break
        off = stream[i] | (stream[i + 1] << 8)
        ml, i = _length(stream, i + 2, tok & 15)
        ml += 4
        if off == 0 or off > len(out):
            raise ValueError(f"offset {off} at output byte {len(out) - base}")
        last_match = (len(out) - base, len(out) - base + ml)
        for _ in range(ml):
            out.append(out[-off])
    if len(out) - base != n_out:
        raise ValueError(f"{len(out) - base} bytes, not {n_out}")
    if last_match and (last_match[1] > n_out - 5
                       or last_match[0] > n_out - 12):
        raise ValueError("a match too near the block's end")
    return bytes(out[base:])


def _linked_rows(seed: int, count: int):
    """(blocks, prefixes): `count` rows of one stream each, 8-16 KB of
    history then 8-16 KB of block, cut from one buffer so that the block
    repeats its history."""
    rng = np.random.default_rng(seed)
    blocks, prefixes = [], []
    for r in range(count):
        half = int(rng.integers(8192, 16385))
        s = int(rng.integers(1 << 30))
        row = gen_text(2 * half, seed=s) if r % 2 else \
            gen_buffer(2 * half, float(rng.uniform(0.5, 0.9)), seed=s)
        prefixes.append(row[:half])
        blocks.append(row[half:])
    return blocks, prefixes


@pytest.mark.parametrize("seed", range(4))
def test_linked_streams_decode_with_their_history(seed):
    blocks, prefixes = _linked_rows(seed, 6)
    lone = gen_text(12000, seed=seed + 100)
    blocks.insert(3, lone)
    prefixes.insert(3, None)
    be = TorchBackend(device="cpu")
    counts = (encode_cuda.launches, encode_cuda.smem_launches,
              encode_cuda.dict_launches)
    streams = be.compress_batch(blocks, level=1, acceleration=1,
                                dict_prefixes=prefixes,
                                favor_dec_speed=False)
    assert (encode_cuda.launches, encode_cuda.smem_launches,
            encode_cuda.dict_launches) == counts
    assert len(streams) == len(blocks)
    reached = 0
    for s, b, p in zip(streams, blocks, prefixes):
        assert decode_linked(s, p or b"", len(b)) == b
        if p is None:
            continue
        try:
            decode_linked(s, b"", len(b))
        except ValueError as e:
            assert "offset" in str(e)
            reached += 1
    # the lone block needs nothing before it; the linked ones search
    # their history, and some reach into it
    assert decode_linked(streams[3], b"", len(lone)) == lone
    assert reached > 0
    alone = be.compress_batch(blocks, level=1, dict_prefixes=None)
    assert alone[3] == streams[3]
    assert sum(map(len, streams)) < sum(map(len, alone))


def test_the_decoder_rejects_an_offset_past_the_history():
    hist = b"0123456789"
    seq = bytes([(2 << 4) | 4]) + b"ab" + (len(hist) + 3).to_bytes(2,
                                                                  "little")
    stream = seq + bytes([13 << 4]) + b"x" * 13
    with pytest.raises(ValueError, match="offset"):
        decode_linked(stream, hist, 2 + 8 + 13)
    ok = seq[:-2] + (len(hist) + 2).to_bytes(2, "little") + stream[len(seq):]
    assert decode_linked(ok, hist, 23) == b"ab" + hist[:8] + b"x" * 13


def test_b1_split_linked_batches_are_the_rows_halves(monkeypatch):
    """`b1_split --linked` times the cell's call: each block is its 128 KB
    row's second half, its history the first (strata of 8 rows here)."""
    from benchmark import corpus
    spec = dict(corpus.load_spec("silesia-like"), stratum_blocks=8)
    monkeypatch.setattr(corpus, "load_spec", lambda name: spec)
    data, _ = corpus.make_corpus(spec, 3, 8, 131072, "cpu")
    batches = b1_split.corpus_batches("silesia-like", 4, 2, 3, history=True,
                                      device="cpu", linked=True)
    for k, (src, lens, dic, dlens) in enumerate(batches):
        rows = data[4 * k: 4 * k + 4]
        assert torch.equal(src, rows[:, 65536:])
        assert torch.equal(dic, rows[:, :65536])
        assert lens.tolist() == dlens.tolist() == [65536] * 4
    plain = b1_split.corpus_batches("silesia-like", 4, 1, 3, device="cpu",
                                    linked=True)
    assert torch.equal(plain[0][0], batches[0][0]) and len(plain[0]) == 2
    with pytest.raises(SystemExit):
        b1_split.main(["--linked"])
