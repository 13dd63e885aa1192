"""The reference decoder: it round-trips the frozen encoder's streams and
refuses every stream that breaks a rule of an independent block."""
import numpy as np
import pytest
import torch

from benchmark import corpus, frozen_encoder, reference
from benchmark.control import decode_wide_copies

SPEC = corpus.load_spec("silesia-like")


def rows_of(ci, n=3, size=16384, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return corpus._gen_blocks(SPEC["classes"][ci], n, size, gen,
                              "cpu").numpy()


@pytest.mark.parametrize("ci", range(4))
def test_round_trips_the_frozen_encoder(ci):
    rows = rows_of(ci)
    for row, s in zip(rows, frozen_encoder.compress_rows(
            rows, [rows.shape[1]] * len(rows))):
        assert reference.decode_block(s, rows.shape[1]) == row.tobytes()


@pytest.mark.parametrize("n", [0, 1, 5, 12, 13, 100])
def test_short_blocks(n):
    block = bytes(range(n))
    s = frozen_encoder.compress_rows(np.frombuffer(block, np.uint8)
                                     .reshape(1, n) if n else
                                     np.zeros((1, 1), np.uint8), [n])[0]
    assert reference.decode_block(s, n) == block


def test_overlapping_match():
    # "ab" then a match of 10 at offset 2, then 5 literals
    stream = bytes([0x26]) + b"ab" + bytes([2, 0]) + bytes([0x50]) + b"vwxyz"
    assert reference.decode_block(stream, 17) == b"ab" * 6 + b"vwxyz"
    assert decode_wide_copies(stream, 17) != b"ab" * 6 + b"vwxyz"


@pytest.mark.parametrize("stream, n, why", [
    (bytes([0x10]) + b"a" + bytes([0, 0]) + bytes([0x50]) + b"vwxyz",
     10, "offset 0"),
    (bytes([0x10]) + b"a" + bytes([2, 0]) + bytes([0x50]) + b"vwxyz",
     10, "offset beyond the output"),
    (bytes([0x40]) + b"abc", 4, "literals past the stream"),
    (bytes([0x20]) + b"ab" + bytes([2]), 8, "stream ends in an offset"),
    (bytes([0x20]) + b"ab" + bytes([2, 0]), 8, "no last literals"),
    (bytes([0x26]) + b"ab" + bytes([2, 0]) + bytes([0x10]) + b"z",
     13, "a match too near the end"),
    (bytes([0x50]) + b"abcde", 6, "shorter than the block"),
    (bytes([0xF0]), 20, "stream ends in a literal length"),
])
def test_refuses(stream, n, why):
    with pytest.raises(reference.FormatError):
        reference.decode_block(stream, n)


def test_refuses_a_linked_block():
    rows = rows_of(0, n=2)
    linked = frozen_encoder.compress_linked(rows[1].tobytes(),
                                            rows[0].tobytes())
    with pytest.raises(reference.FormatError):
        reference.decode_block(linked, rows.shape[1])


def test_imports_nothing_of_the_program():
    import ast
    import pathlib
    tree = ast.parse(pathlib.Path(reference.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert all(m.split(".")[0] == "__future__" for m in names), names
