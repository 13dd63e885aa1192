"""The sample that the check decodes covers the whole batch."""
import pytest

from benchmark import check


@pytest.mark.parametrize("per_call, batch", [(1, 64), (4, 3072), (3, 10)])
def test_every_position_comes_up_in_batch_over_per_call_calls(per_call,
                                                              batch):
    picks = check.Picks(2**31 + 7, per_call, batch)
    calls = -(-batch // per_call)
    seen = [j for i in range(calls) for j in picks(i)]
    assert set(seen) == set(range(batch))
    assert all(len(picks(i)) == per_call for i in range(calls))


def test_the_picks_follow_the_seed():
    a, b = check.Picks(5, 2, 64), check.Picks(6, 2, 64)
    assert [a(i) for i in range(8)] == [check.Picks(5, 2, 64)(i)
                                        for i in range(8)]
    assert [a(i) for i in range(8)] != [b(i) for i in range(8)]


@pytest.mark.parametrize("workers", [1, 3])
def test_the_pool_finds_what_one_process_finds(workers):
    from benchmark import frozen_encoder
    import numpy as np
    rows = np.random.default_rng(3).integers(0, 4, (12, 4096), np.uint8)
    streams = frozen_encoder.compress_rows(rows, [4096] * 12, 1)
    kept = [(0, j, s if j % 4 else s[:-1]) for j, s in enumerate(streams)]
    bad, notes = check.verify("stream", kept,
                              lambda k, j: rows[j].tobytes(), workers)
    assert bad == 3 and [n.split(":")[0] for n in notes] == [
        "batch 0 block 0", "batch 0 block 4", "batch 0 block 8"]


def test_a_decompressed_block_must_equal_its_source():
    kept = [(0, 0, b"abc"), (0, 1, b"abd"), (0, 2, None)]
    bad, notes = check.verify("block", kept, lambda k, j: b"abc", 1)
    assert bad == 2
    assert "differs at byte 2" in notes[0] and "missing" in notes[1]
