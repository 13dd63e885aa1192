"""B2's design on the CPU: `decode_cuda.DecodeParallelModel` runs the order
of `csrc/decode_serial.cu` actor by actor, under a seeded random
schedule: the parse warp (32 lane records, one hop a sequence, the checks
once per 32 hops) publishing descriptors into a ring, `head` released
with the output end of the last descriptor; copy warps taking them in
turn, each match copied once the published progress of the other warps
covers its source window. It asserts that every write lies inside the
row, that every output read is of a final byte and that no ring slot is
overwritten before it is read.

Its results are held to the plain version (`decode_blocks_plain`) and to
the JAX package's `_decode_kernel` in interpret mode: err and olen on
every row, malformed ones included, and out[:olen] where err is 0 (bytes
past olen, and rows that err, are unspecified). Cases: corpora with 1,
4 and 7 copy warps and rings of 32 to 256 slots, a 60 KB match,
overlapping offsets 1-31, 40 mutated or truncated streams, dict with
partial history, `loose`, and rows wider than 64 KB (the 4 MB route's
widths). Tolerance: exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lz4_tpu.block.decode_pallas import decode_blocks_pallas  # noqa: E402
from lz4_tpu.block.ref_codec import compress_block  # noqa: E402
from lz4_tpu_torch.block import decode_cuda  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _three(streams, cap_out=8192, prefixes=None, loose=False, copy_warps=4,
           ring=256, seed=0, jax_too=True, batch=32):
    """Decode with the model, the plain version and (unless jax_too is
    False) the JAX kernel; assert parity; return the model's rows."""
    cap_in = max(16, max(len(c) for c in streams))
    arrays = pack_blocks(streams, prefixes, cap=cap_in,
                         with_dict=prefixes is not None)
    t = to_device_batch(*arrays, device="cpu")
    mo, ml, me = decode_cuda.decode_blocks_model(
        *t, cap_out=cap_out, loose=loose, copy_warps=copy_warps, ring=ring,
        seed=seed, batch=batch)
    po, pl, pe = decode_cuda.decode_blocks_plain(*t, cap_out=cap_out,
                                                 loose=loose)
    assert torch.equal(me, pe) and torch.equal(ml, pl)
    want = [(po, pl, pe)]
    if jax_too:
        comp, lens, db, dl = arrays
        jo, jl, je = (torch.from_numpy(np.array(x)) for x in
                      decode_blocks_pallas(
                          jnp.asarray(comp), jnp.asarray(lens),
                          None if db is None else jnp.asarray(db),
                          None if dl is None else jnp.asarray(dl),
                          cap_out=cap_out, interpret=True, loose=loose))
        assert torch.equal(me, je.int()) and torch.equal(ml, jl.int())
        want.append((jo, jl, je))
    for i in range(len(streams)):
        if not me[i]:
            n = int(ml[i])
            for o, _, _ in want:
                assert torch.equal(mo[i, :n], o[i, :n]), i
    return mo, ml, me


# copy warps, ring slots and head releases: as shipped, and at the edges
DESIGNS = {"shipped": dict(cap_out=8192),
           "one_warp": dict(cap_out=8192, copy_warps=1, ring=32, batch=1),
           "wide_row": dict(cap_out=70000),
           "seven_warps": dict(cap_out=70000, copy_warps=7, ring=32,
                               batch=16)}


@pytest.mark.parametrize("design", list(DESIGNS))
def test_corpora(design):
    kw = DESIGNS[design]
    rng = np.random.default_rng(len(design))
    srcs = []
    for n in (13, 300, 4096):
        srcs += [gen_text(n, seed=n), gen_buffer(n, 0.6, seed=n),
                 b"\x00" * n, rng.bytes(n)]
    srcs += [b"A", b"", b"ab" * 2000]
    comp = blockcodec.compress_batch(srcs) + \
        [blockcodec.compress_hc(s, 9) for s in srcs[:4]]
    out, olen, err = _three(comp, seed=len(design), **kw)
    for i, s in enumerate(srcs + srcs[:4]):
        assert not err[i] and out[i, : len(s)].numpy().tobytes() == s


def test_long_match_60k():
    srcs = [b"\xaa" * 60000, (b"0123456789abcdef" * 4096)[:60000]]
    comp = [blockcodec.compress_hc(s, 9) for s in srcs]
    out, _, err = _three(comp, 65536, ring=32)
    for i, s in enumerate(srcs):
        assert not err[i] and out[i, : len(s)].numpy().tobytes() == s


@pytest.mark.parametrize("seed,cap_out", [(0, 2048), (1, 70000)])
def test_overlapping_offsets_1_to_31(seed, cap_out):
    """Matches shorter in offset than in length: each byte is byte
    (i mod offset) of the period before it, some of it the sequence's own
    literals, the rest the previous sequences' output."""
    rng = np.random.default_rng(seed)
    srcs = [rng.bytes(off) * (700 // off + 3) + rng.bytes(40)
            for off in range(1, 32)]
    comp = blockcodec.compress_batch(srcs)
    out, _, err = _three(comp, cap_out, seed=seed, ring=32)
    for i, s in enumerate(srcs):
        assert not err[i] and out[i, : len(s)].numpy().tobytes() == s


def _mutations(streams, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cc = bytearray(streams[k % len(streams)])
        mode = rng.integers(0, 3)
        if mode == 0:
            cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        elif mode == 1:
            cc = cc[: rng.integers(1, len(cc))]
        else:
            for _ in range(6):
                cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        out.append(bytes(cc))
    return out


@pytest.mark.parametrize("seed,cap_out", [(11, 4096), (12, 70000)])
def test_mutated_and_truncated_streams(seed, cap_out):
    good = blockcodec.compress_batch(
        [gen_text(2048, seed=3), gen_buffer(2048, 0.6, seed=4)])
    bad = _mutations(good, 40, seed)
    _, _, err = _three(bad, cap_out, ring=32, seed=seed)
    assert err.sum() > 0
    # a small window: streams that write past it fail at the right place
    _three(bad[:10] + good, 1024, copy_warps=2, seed=seed)


@pytest.mark.parametrize("cap_out", [8192, 70000])
def test_dict_partial_history(cap_out):
    hist = gen_text(70000, seed=21)
    blk = hist[-5000:-2000] + gen_text(3000, seed=22)
    comp = compress_block(blk, dict_prefix=hist[-65536:])
    cases = [comp] + [comp[:k] for k in (3, len(comp) // 2)]
    out, _, err = _three(cases, cap_out, prefixes=[hist] * len(cases))
    assert not err[0] and out[0, : len(blk)].numpy().tobytes() == blk
    # a shorter history makes far offsets reach before it
    _, _, err = _three(cases, cap_out, prefixes=[hist[-2500:]] * len(cases))
    assert err[0] == 1
    _three(cases, cap_out, prefixes=[None] * len(cases))


@pytest.mark.parametrize("loose,cap_out", [(False, 4096), (True, 4096),
                                           (True, 70000)])
def test_loose_pieces(loose, cap_out):
    piece = b"\x44abcd\x04\x00\x00"      # ends right after a match
    cases = [piece, b"\x42ab\x02\x00\x10Z", piece + b"\x00"]
    cases += _mutations(blockcodec.compress_batch([gen_text(1500, seed=9)]),
                        8, seed=13)
    out, olen, err = _three(cases, cap_out, loose=loose)
    assert bool(err[0]) != loose
    if loose:
        assert out[0, : olen[0]].numpy().tobytes() == b"abcdabcdabcd"


def test_rows_wider_than_64k():
    """Rows over 64 KB (the 4 MB route's widths), long matches included."""
    srcs = [gen_text(70000, seed=31), b"z" * 69000]
    comp = blockcodec.compress_batch(srcs)
    out, _, err = _three(comp, 72000, jax_too=False)
    for i, s in enumerate(srcs):
        assert not err[i] and out[i, : len(s)].numpy().tobytes() == s
    _three([compress_block(b"q" * 3000), comp[0][:500]], 66000)


def test_model_catches_an_early_read():
    """The one-launch design's final-byte check is live: with the matches'
    wait on the other warps' progress dropped, some schedule reads a byte
    too early."""
    comp = blockcodec.compress(b"ab" * 300 + gen_text(2000, seed=5))
    caught = 0
    for seed in range(20):
        m = decode_cuda.DecodeParallelModel(3, 32, seed, wait=False, batch=1)
        try:
            m.decode(comp + bytes(16), len(comp), b"", 0, 70000, False)
        except AssertionError as e:
            assert "before it is final" in str(e)
            caught += 1
    assert caught > 0


def test_batches_of_32_sequences_end_anywhere():
    """The checks run once per 32 hops: streams whose first failing, or
    last, sequence falls at every place in a batch."""
    good = blockcodec.compress(gen_text(3000, seed=8))
    seqs = decode_cuda.parse_sequences(good, len(good), 0, 0, 4096, False)
    n = len(list(seqs))
    cases = [good] + [good[: 8 * k] for k in range(1, 40)]   # truncated
    _, _, err = _three(cases, 4096, copy_warps=2, ring=32)
    assert n > 40 and not err[0] and err[1:].sum() >= 30
