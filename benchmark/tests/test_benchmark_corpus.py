"""The corpus generator: seeded, deterministic, and in Silesia's class
shares."""
import numpy as np
import pytest
import torch

from benchmark import corpus, frozen_encoder

SPEC = corpus.load_spec("silesia-like")


def small_spec(stratum=64):
    return dict(SPEC, stratum_blocks=stratum)


def test_same_seed_same_bytes_other_seed_other_bytes():
    spec = small_spec()
    a, ca = corpus.make_corpus(spec, 2**31 + 7, 64, 4096, "cpu")
    b, cb = corpus.make_corpus(spec, 2**31 + 7, 64, 4096, "cpu")
    c, _ = corpus.make_corpus(spec, 2**31 + 8, 64, 4096, "cpu")
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and tuple(a.shape) == (64, 4096)


@pytest.mark.parametrize("stratum", [8, 64, 256, 768])
def test_stratum_counts_follow_the_shares(stratum):
    shares = [c["share"] for c in SPEC["classes"]]
    counts = corpus.stratum_counts(shares, stratum)
    assert sum(counts) == stratum
    for n, s in zip(counts, shares):
        assert abs(n - s * stratum) < 1


def test_every_stratum_holds_the_shares_in_another_order():
    spec = small_spec(stratum=32)
    gen = torch.Generator().manual_seed(5)
    cls = corpus.block_classes(spec, 96, gen)
    want = corpus.stratum_counts([c["share"] for c in SPEC["classes"]], 32)
    strata = cls.view(3, 32)
    for row in strata:
        assert torch.bincount(row, minlength=4).tolist() == want
    assert not torch.equal(strata[0], strata[1])


def test_the_published_stratum_is_silesia_byte_shares():
    counts = corpus.stratum_counts([c["share"] for c in SPEC["classes"]],
                                   SPEC["stratum_blocks"])
    total = SPEC["silesia_bytes"]
    assert sum(c["file_bytes"] for c in SPEC["classes"]) == total
    for n, c in zip(counts, SPEC["classes"]):
        assert abs(n / SPEC["stratum_blocks"] - c["file_bytes"] / total) \
            < 0.01


def test_classes_differ_in_compressibility_as_their_files_do():
    """Text and databases compress better than executables, and the
    numeric class least (a record of the model, not of Silesia)."""
    ratios = {}
    for ci, cls in enumerate(SPEC["classes"]):
        gen = torch.Generator().manual_seed(11)
        rows = corpus._gen_blocks(cls, 4, 16384, gen, "cpu").numpy()
        streams = frozen_encoder.compress_rows(rows, [16384] * 4)
        ratios[cls["name"]] = rows.size / sum(map(len, streams))
    assert ratios["database"] > ratios["text"] > ratios["executable"] \
        > ratios["numeric"] > 1.0


def test_a_match_repeats_earlier_bytes_of_its_block():
    """With every operation a match after the first 16 bytes, each byte
    past them is a copy: the block holds no byte its first 16 lack."""
    cls = dict(SPEC["classes"][3], match_prob=1.0, min_history=16)
    gen = torch.Generator().manual_seed(3)
    rows = corpus._gen_blocks(cls, 2, 4096, gen, "cpu").numpy()
    for row in rows:
        head = set(row[:16].tolist())
        # the first operation may be a literal run up to lit_run[1] long
        head |= set(row[: 16 + cls["lit_run"][1]].tolist())
        assert set(np.unique(row).tolist()) <= head
