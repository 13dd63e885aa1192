"""The linked-frame cell `lz4f-linked-64k.compress`: a small run on the
CPU is correct, the join of a linked stream with its history decodes by
the strict reference, a stream that reaches past its history is
flagged, and the control is not correct."""
import io
import json

import numpy as np
import pytest
import torch

from benchmark import (cells, check, control, corpus, reference,
                       reference_linked, run)
from benchmark.tests.small import small_cell

CELL = "lz4f-linked-64k.compress"


def _small():
    return small_cell(CELL, block_bytes=16384)


def _literals(data: bytes) -> bytes:
    """One literal-only sequence of `data`."""
    n = len(data)
    if n < 15:
        return bytes([n << 4]) + data
    n -= 15
    return b"\xf0" + b"\xff" * (n // 255) + bytes([n % 255]) + data


def _linked(history: bytes, offset: int) -> tuple[bytes, bytes]:
    """(block, stream): a linked block of 3 literals, a match of 8 bytes
    at `offset` back (into the history where it reaches past the
    literals) and 20 literals, and its stream."""
    lits, tail = b"abc", bytes(range(65, 85))
    out = bytearray(history + lits)
    for _ in range(8):
        out.append(out[len(out) - offset] if offset <= len(out) else 0)
    block = bytes(out[len(history):]) + tail
    seq = bytes([(len(lits) << 4) | (8 - 4)]) + lits + \
        offset.to_bytes(2, "little")
    return block, seq + _literals(tail)


def test_the_cell_finds_its_pieces():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1
    entry = cell.entry_class()
    assert (entry.kind, entry.label) == ("stream", "compress_batch")
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "compress_MBs", "call_p95_ms", "ratio"}
    assert {m["name"] for m in cell.per_layer} == {
        "host_ms.compress", "copy_ms.compress", "kernel_roofline.compress",
        "device_idle.compress"}
    cfg = cell.config
    assert (cfg["level"], cfg["acceleration"], cfg["block_bytes"]) == (
        1, 1, 131072)
    assert cfg["corpus_bytes"] == cfg["corpus_blocks"] * cfg["block_bytes"] \
        // 2
    assert cfg["corpus_blocks"] % cell.mix["batch_blocks"] == 0
    assert cfg["corpus_blocks"] % cell.corpus["stratum_blocks"] == 0


@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_is_correct(traced):
    from lz4_tpu_torch.block import encode_cuda
    out = io.StringIO()
    before = encode_cuda.dict_launches
    r = run.execute(_small(), 2**31 + 77, 0.3, traced, device="cpu",
                    out=out)
    assert r["correct"] and r["failed"] == 0
    assert all(v == {"value": 0, "limit": 0} for v in r["checks"].values())
    info = json.loads(out.getvalue().splitlines()[0][len("info "):])
    assert info["checked_blocks"] > 0
    # the rate counts the blocks, half of each row
    assert info["uncompressed_bytes"] == info["calls"] * 8 * 8192
    # the plain version on the CPU is no launch
    assert info["counters"]["encode_cuda.dict_launches"] == before
    if not traced:
        assert set(r["metrics"]) == {"setup_s", "compress_MBs",
                                     "call_p95_ms", "ratio"}
        assert r["metrics"]["ratio"]["value"] > 1.0


def test_the_cell_s_streams_join_and_need_their_history():
    """The entry's streams of one small batch: each joined with its
    history decodes to its row; alone, some reach into the history, and
    together they are smaller than the same blocks compressed alone."""
    cell = _small()
    data, _ = corpus.make_corpus(cell.corpus, 2**31 + 5, 16, 16384, "cpu")
    host = data.numpy()
    entry = cell.entry_class()(run.Run(
        cell=cell, seed=5, device=torch.device("cpu"), data=data, host=host,
        batch_blocks=8, n_batches=2))
    res = entry.call(1)
    kept = entry.finish(entry.keep(1, res, list(range(8))))
    for k, j, joined in kept:
        row = host[8 + j].tobytes()
        assert reference.decode_block(joined, len(row)) == row
    alone = [check.block_fault("stream", s, host[8 + j, 8192:].tobytes())
             for j, s in enumerate(res)]
    assert any(f and "offset" in f for f in alone)
    independent = entry.backend.compress_batch(
        entry.batches[1], level=1, dict_prefixes=[None] * 8)
    assert sum(map(len, res)) < sum(map(len, independent))


def test_join_keeps_offsets_into_the_history():
    hist = bytes(range(200, 256)) * 4
    for offset in (1, 3, 4, 10, len(hist), len(hist) + 3):
        block, stream = _linked(hist, offset)
        joined = reference_linked.join(hist, stream)
        assert reference.decode_block(joined, len(hist) + len(block)) == \
            hist + block, offset


def test_an_offset_past_the_history_is_flagged():
    hist = bytes(range(200, 256)) * 4
    block, stream = _linked(hist, len(hist) + 3 + 1)
    joined = reference_linked.join(hist, stream)
    with pytest.raises(reference.FormatError, match="offset"):
        reference.decode_block(joined, len(hist) + len(block))


@pytest.mark.parametrize("n", [0, 1, 14, 15, 16, 269, 270, 271, 5000])
def test_join_of_a_literal_stream(n):
    """Literal runs on both sides of each length-field boundary."""
    rng = np.random.default_rng(n)
    hist = rng.bytes(n)
    block = rng.bytes(40)
    joined = reference_linked.join(hist, _literals(block))
    assert reference.decode_block(joined, n + 40) == hist + block


@pytest.mark.parametrize("stream", [b"", b"\xf0", b"\xf0\xff", b"\x50ab"])
def test_an_unparsable_stream_comes_back_as_it_is(stream):
    assert reference_linked.join(b"history", stream) == stream
    assert check.block_fault("stream", stream, b"history" + b"x" * 5)


def test_the_control_is_not_correct():
    cell = small_cell(CELL, blocks=16, stratum=8, block_bytes=16384)
    r = control.reading(cell, 2**31 + 21, calls=6, device="cpu")
    assert r["checked_blocks"] > 0
    assert r["bad_blocks"] > r["limit"] and not r["correct"]
