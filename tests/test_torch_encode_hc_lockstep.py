"""B5's design on the CPU: `encode_hc.encode_blocks_hc_lockstep` models
what `csrc/encode_hc.cu` does (the chain-delta pre-pass as a vectorised
torch function, `chain_deltas`; parses that read only that table, split
into speculative parses per segment, joined by repairs; chain walks 32
candidates a step scored in chain order; the warp-wide counts lane by
lane).

(a) The invariant the pre-pass rests on: in the serial parse, search
positions never decrease and every position below a search has been
inserted, so the table the serial inserts have written equals the
pre-pass's at every search. (b) The model's streams equal the plain
version's (`encode_blocks_hc_plain`), the JAX kernel's in interpret mode
(caps <= 4096) and the host C `compress_hc`'s, at levels 3, 5 and 9 and
with `favor_dec_speed`, on rows that share hash slots, zeros, periodic
rows (the repeat-pattern path), random rows and rows under 13 bytes, with
1, 4, 32 and 256 segments and with lists small enough to fill; and with
the parts taken in turns from two halves, each half marking in its own
marks, as a 2-CTA cluster takes them. Tolerance: exact (LZ4 streams are
deterministic bytes).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu.block.encode_hc_pallas import encode_blocks_hc_pallas  # noqa: E402
from lz4_tpu_torch.block import encode_hc  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_slot_words,  # noqa: E402
                                         gen_text, mixed_corpus)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [gen_text(n, seed=seed), mixed_corpus(n, seed=seed + 1),
            gen_slot_words(n, pool=16, seed=seed + 2), bytes(n),
            b"abab" * (n // 8) + b"Q" + b"abab" * (n // 16),
            (b"xyz" * n)[:n], rng.bytes(n // 2),
            gen_buffer(n, 0.97, seed=seed + 3), b"abcabcabcab", b"q" * 12,
            b""]


def _streams(out, cs):
    return [out[i, :k].numpy().tobytes() for i, k in enumerate(cs.tolist())]


def _model(rows, cap, model=None, **kw):
    """The model's streams, held to the plain version's; returns them and
    the model."""
    src, lens, _, _ = pack_blocks(rows, cap=cap)
    s, n = torch.from_numpy(src), torch.from_numpy(lens)
    po, pc, pt = encode_hc.encode_blocks_hc_plain(s, n, cap_n=cap, **kw)
    mo, mc, mt, model = encode_hc.encode_blocks_hc_lockstep(
        s, n, cap_n=cap, model=model, **kw)
    assert torch.equal(mc, pc) and torch.equal(mt, pt)
    got = _streams(mo, mc)
    assert got == _streams(po, pc)
    return got, model


def _serial_table(row, n):
    """The delta table after the serial parse's inserts of every position
    a search can reach."""
    buf = row + bytes(512)
    _, H = encode_hc._tables(buf)
    head = [-1] * (1 << encode_hc.HASH_LOG)
    chain = [0] * len(row)
    for q in range(max(n - 11, 0)):
        e = head[H[q]]
        chain[q] = q - e if e >= 0 else 0
        head[H[q]] = q
    return chain


def test_chain_deltas_equal_the_serial_inserts():
    rows = _rows(3000, seed=1)
    src, lens, _, _ = pack_blocks(rows, cap=3001)
    lens[0] = 2000                       # bytes past the length are not 0
    got = encode_hc.chain_deltas(torch.from_numpy(src),
                                 torch.from_numpy(lens), cap_n=3001)
    for b, n in enumerate(lens.tolist()):
        row = src[b].tobytes()
        assert got[b].tolist() == _serial_table(row, n), b


@pytest.mark.parametrize("level", [3, 9])
def test_serial_parse_reads_only_the_pre_pass(level):
    """(a): one segment with `serial_check`: at every search the positions
    have not decreased, and the serial inserts so far hold the pre-pass's
    deltas and the head the parse reads."""
    model = encode_hc.HCLockstepModel(segments=1, serial_check=True)
    _model(_rows(3000, seed=2), 3072, model, level=level)
    assert model.searches > 1000 and model.fallbacks == 0


@pytest.mark.parametrize("level,favor", [(3, False), (5, False), (9, False),
                                         (9, True), (4, True)])
def test_model_matches_plain_and_c(level, favor):
    rows = _rows(2500, seed=level)
    got, model = _model(rows, 2560, level=level, favor_dec_speed=favor)
    for row, s in zip(rows, got):
        assert s == blockcodec.compress_lazy(row, encode_hc.depth_for(level),
                                             favor_dec_speed=favor)
        if not favor:
            assert s == blockcodec.compress_hc(row, level)
    assert model.syncs > 0 and model.fallbacks == 0


@pytest.mark.parametrize("level,favor", [(9, False), (3, True)])
def test_model_matches_the_jax_kernel(level, favor):
    rows = _rows(1500, seed=7)
    cap = 1536
    got, _ = _model(rows, cap, level=level, favor_dec_speed=favor)
    src, lens, _, _ = pack_blocks(rows, cap=cap)
    out, cs, _ = (np.asarray(x) for x in encode_blocks_hc_pallas(
        jnp.asarray(src), jnp.asarray(lens), cap_n=cap, level=level,
        interpret=True, favor_dec_speed=favor))
    assert got == [out[i, : cs[i]].tobytes() for i in range(len(rows))]


@pytest.mark.parametrize("segments,caps", [(4, None), (32, (6, 1000)),
                                           (32, (20, 2)), (7, (3, 3)),
                                           (256, None), (256, (6, 1000)),
                                           (256, (20, 2))])
def test_segments_and_full_lists(segments, caps):
    """Joins at every segment count (256: a 2-CTA cluster's parts);
    speculative lists that fill fall back to their last state-0 turn,
    repair lists that fill to one serial parse."""
    rows = _rows(4000, seed=11) + [gen_text(13, seed=3), bytes(40)]
    model = encode_hc.HCLockstepModel(segments, caps)
    _model(rows, 4096, model, level=9)
    _model(rows, 4096, model, level=3)
    if caps and caps[1] < 10:
        assert model.fallbacks > 0
    else:
        assert model.fallbacks == 0 and model.syncs > 0
    if caps == (6, 1000):
        assert model.repaired > 0       # the repairs parsed what was cut


@pytest.mark.parametrize("level", [3, 9])
def test_batched_walk_visits_what_the_serial_walk_visits(level):
    """The walk 32 candidates a step visits and scores exactly the
    candidates the serial walk does, in the same order (equal counts and
    streams); periodic rows take the serial walk at level 9."""
    rows = [b"abab" * 1000, bytes(4000), gen_text(4000, seed=5),
            gen_slot_words(4000, pool=8, seed=6)]
    counts = []
    for batched in (True, False):
        model = encode_hc.HCLockstepModel(segments=1, batched=batched)
        got, _ = _model(rows, 4000, model, level=level)
        counts.append((got, model.searches, model.candidates, model.scored,
                       model.bytes))
    assert counts[0] == counts[1]
    assert counts[0][2] >= counts[0][3] > 0


@pytest.mark.parametrize("level,favor", [(9, False), (3, False), (9, True)])
def test_pair_order_matches_plain_c_and_the_jax_kernel(level, favor):
    """256 parts taken in turns from two halves, each half's marks in its
    own CTA's marks, ORed before the repairs (a 2-CTA cluster): the same
    streams and joins as the parts taken in order, equal to the plain
    version, C and the JAX kernel."""
    rows = _rows(1500, seed=21)
    cap = 1536
    pair = encode_hc.HCLockstepModel(encode_hc.PAIR_SEGMENTS,
                                     order=encode_hc.pair_order(), ctas=2)
    got, pair = _model(rows, cap, pair, level=level, favor_dec_speed=favor)
    ordered = encode_hc.HCLockstepModel(encode_hc.PAIR_SEGMENTS)
    again, ordered = _model(rows, cap, ordered, level=level,
                            favor_dec_speed=favor)
    assert got == again
    assert (pair.syncs, pair.repaired, pair.fallbacks) == (
        ordered.syncs, ordered.repaired, ordered.fallbacks)
    assert pair.syncs > 0 and pair.fallbacks == 0
    for row, s in zip(rows, got):
        assert s == blockcodec.compress_lazy(row, encode_hc.depth_for(level),
                                             favor_dec_speed=favor)
        if not favor:
            assert s == blockcodec.compress_hc(row, level)
    src, lens, _, _ = pack_blocks(rows, cap=cap)
    out, cs, _ = (np.asarray(x) for x in encode_blocks_hc_pallas(
        jnp.asarray(src), jnp.asarray(lens), cap_n=cap, level=level,
        interpret=True, favor_dec_speed=favor))
    assert got == [out[i, : cs[i]].tobytes() for i in range(len(rows))]


def test_pair_order_with_full_lists():
    """A pair's order at 256 parts with lists small enough to fill: the
    speculative parses roll back and a repair's list overflows into the
    serial parse, with the same bytes as the plain version, C and the JAX
    kernel."""
    rows = _rows(1500, seed=12)[:5] + [bytes(1500), b"ab" * 750]
    cap = 1536
    src, lens, _, _ = pack_blocks(rows, cap=cap)
    out, cs, _ = (np.asarray(x) for x in encode_blocks_hc_pallas(
        jnp.asarray(src), jnp.asarray(lens), cap_n=cap, level=9,
        interpret=True))
    want = [out[i, : cs[i]].tobytes() for i in range(len(rows))]
    assert want == [blockcodec.compress_hc(r, 9) for r in rows]
    for caps, fell in (((6, 1000), False), ((20, 2), True)):
        model = encode_hc.HCLockstepModel(
            encode_hc.PAIR_SEGMENTS, caps, order=encode_hc.pair_order(),
            ctas=2)
        got, model = _model(rows, cap, model, level=9)
        assert got == want
        assert (model.fallbacks > 0) == fell


def test_pair_order_is_a_permutation():
    assert encode_hc.pair_order(6) == [0, 3, 1, 4, 2, 5]
    assert encode_hc.pair_order(5) == [0, 3, 1, 4, 2]
    assert sorted(encode_hc.pair_order()) == list(range(256))
    with pytest.raises(ValueError):
        encode_hc.HCLockstepModel(4, order=[0, 1, 1, 2])
