"""The sort/scan decoder as torch ops (`block/decode_sortscan.py`) against
`lz4_tpu.block.decode_jax` on the CPU: round trips, HC streams, long and
short dicts, malformed streams, per-row `out_caps`, `partial` mode and
the > 64 KB tier; `decode_blocks_host`; the corpus functions and
`encode_blocks_host` against `lz4_tpu.block.corpus` and `encode_jax`; and
`TorchBackend`'s routes with `serial_decode` / `serial_encode` off.
Tolerance: exact (every row's out, out_lens and errs, error rows
included; bytes)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu.block import corpus as jcorpus  # noqa: E402
from lz4_tpu.block import decode_jax, encode_jax  # noqa: E402
from lz4_tpu_torch.block import corpus, decode_sortscan  # noqa: E402
from lz4_tpu_torch.block import encode_sortscan  # noqa: E402
from lz4_tpu_torch.block.backend import BlockDecodeError  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel import engine as tengine  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

ROWS, CAP = 8, 4096
HIST = gen_text(70_000, seed=31)


def _mutate(streams, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cc = bytearray(streams[k % len(streams)])
        mode = rng.integers(0, 3)
        if mode == 0:
            cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        elif mode == 1:
            cc = cc[: rng.integers(1, len(cc) + 1)]
        else:
            for _ in range(6):
                cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
        out.append(bytes(cc))
    return out


def _dict_streams():
    srcs = [HIST[100:2100] + b"new" + HIST[60000:61500],
            HIST[-4000:], gen_text(3000, seed=32), HIST[:64] * 60]
    return [blockcodec.compress(s, dict_prefix=HIST) for s in srcs], \
        [HIST] * len(srcs)


def _case(name):
    """(streams, dict prefixes or None, out_caps or None, partial)."""
    srcs = [b"", b"a", b"abcabcabcabcabcabcabcabcabc", b"x" * CAP,
            bytes(range(256)) * 16, gen_buffer(CAP, 0.7, seed=3),
            gen_buffer(CAP, 0.0, seed=4), gen_buffer(300, 0.95, seed=6)]
    plain = [blockcodec.compress(s) for s in srcs]
    if name == "roundtrip":
        return plain, None, None, False
    if name == "hc":
        texts = [gen_text(CAP, seed=s) for s in range(4)]
        return ([blockcodec.compress_hc(t, level=lv) for t, lv in
                 zip(texts, (3, 9, 12, 9))] + plain[4:]), None, None, False
    if name == "dict":
        streams, prefixes = _dict_streams()
        return streams + plain[:4], prefixes + [None] * 4, None, False
    if name == "short_dict":
        hist = b"hello world, this is history"
        data = [hist + b" repeated", hist * 40, b"hello" * 100, b"new"]
        prefixes = [hist, hist[-7:], b"hello", b"x"]
        return ([blockcodec.compress(d, dict_prefix=p)
                 for d, p in zip(data, prefixes)], prefixes, None, False)
    if name == "malformed":
        return _mutate(plain[2:], ROWS, seed=33), None, None, False
    if name == "malformed_dict":
        streams, prefixes = _dict_streams()
        return (_mutate(streams, ROWS, seed=34),
                (prefixes * 2)[:ROWS], None, False)
    if name == "out_caps":
        caps = [1, 1, 27, CAP - 1, CAP, CAP - 13, 100, 300]
        return plain, None, caps, False
    if name == "partial":
        caps = [0, 1, 10, 100, 4000, 2000, CAP, 150]
        cut = [c[: max(1, len(c) // 2)] if i % 3 == 2 else c
               for i, c in enumerate(plain)]
        return cut, None, caps, True
    if name == "partial_dict":
        streams, prefixes = _dict_streams()
        cut = [streams[0][:40]] + streams[1:]
        return cut, prefixes, [1500, 4000, 10, 2000], True
    raise KeyError(name)


CASES = ["roundtrip", "hc", "dict", "short_dict", "malformed",
         "malformed_dict", "out_caps", "partial", "partial_dict"]


def _both(streams, prefixes, caps, partial, cap_out=CAP, rows=ROWS):
    """(JAX, torch) results on the same arrays, padded to `rows` rows."""
    streams = list(streams) + [b"\x00"] * (rows - len(streams))
    prefixes = (list(prefixes) + [None] * (rows - len(prefixes))
                if prefixes else None)
    caps = np.asarray(list(caps or []) + [cap_out] * (rows - len(caps or [])),
                      np.int32)
    cap_in = max(CAP, max(len(s) for s in streams))
    arrays = pack_blocks(streams, prefixes, cap=cap_in, with_dict=True)
    has_dict = prefixes is not None
    want = decode_jax.decode_blocks(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(caps),
        cap_out=cap_out, has_dict=has_dict, partial=partial)
    got = decode_sortscan.decode_blocks(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(caps),
        cap_out=cap_out, has_dict=has_dict, partial=partial)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("name", CASES)
def test_decode_blocks_matches_jax(name):
    want, got = _both(*_case(name))
    for w, g, what in zip(want, got, ("out", "out_lens", "errs")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    errs = got[2]
    if name in ("roundtrip", "hc", "dict", "short_dict", "partial",
                "partial_dict"):
        assert not errs.any()
    if name.startswith("malformed") or name == "out_caps":
        assert errs.any()


def test_big_tier_matches_jax():
    """cap_out above 64 KB: literal runs keep their full length (a run of
    100000 literals, over 16 bits)."""
    rng = np.random.default_rng(35)
    srcs = [gen_text(120_000, seed=36), rng.bytes(100_000)]
    want, got = _both([blockcodec.compress(s) for s in srcs], None, None,
                      False, cap_out=131072, rows=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert not got[2].any()
    assert [got[0][i, : len(s)].tobytes() for i, s in enumerate(srcs)] == srcs


def test_decode_blocks_host_matches_jax():
    srcs = [gen_text(3000, seed=37), b"", gen_buffer(9000, 0.8, seed=38)]
    comp = [blockcodec.compress(s) for s in srcs]
    caps = [max(1, len(s)) for s in srcs]
    got = decode_sortscan.decode_blocks_host(comp, caps, device="cpu")
    assert got == decode_jax.decode_blocks_host(comp, caps) == srcs
    got = decode_sortscan.decode_blocks_host(comp[:1], [1234], partial=True,
                                             device="cpu")
    assert got == decode_jax.decode_blocks_host(comp[:1], [1234],
                                                partial=True)
    assert got == [srcs[0][:1234]]
    for bad, caps in (([comp[0][:-4]], [3000]), ([comp[2]], [8999])):
        with pytest.raises(BlockDecodeError):
            decode_sortscan.decode_blocks_host(bad, caps, device="cpu")
        with pytest.raises(ValueError):
            decode_jax.decode_blocks_host(bad, caps)


def test_rows_decode_alike_in_any_chunking(monkeypatch):
    streams, prefixes = _dict_streams()
    arrays = [torch.from_numpy(a) for a in pack_blocks(
        streams, prefixes, cap=CAP, with_dict=True)]
    whole = decode_sortscan.decode_blocks(*arrays, cap_out=CAP,
                                          has_dict=True)
    monkeypatch.setitem(decode_sortscan.BUDGET, "cpu", 1)
    assert decode_sortscan.chunk_rows(CAP, CAP, torch.device("cpu")) == 1
    one_by_one = decode_sortscan.decode_blocks(*arrays, cap_out=CAP,
                                               has_dict=True)
    for a, b in zip(whole, one_by_one):
        assert torch.equal(a, b)


def test_corpus_functions_match_jax():
    NC, B = 2, 2
    data = [gen_buffer(CAP, match_prob=p, seed=i)
            for i, p in enumerate((0.0, 0.5, 0.9, 0.7))]
    src = np.stack([np.frombuffer(d, np.uint8) for d in data]).reshape(
        NC, B, CAP)
    lens = np.full((NC, B), CAP, np.int32)
    db = np.zeros((B, 65536), np.uint8)
    dl = np.zeros(B, np.int32)
    want = jcorpus.encode_corpus(jnp.asarray(src), jnp.asarray(lens),
                                 jnp.asarray(db), jnp.asarray(dl), cap_n=CAP,
                                 has_dict=False)
    got = corpus.encode_corpus(torch.from_numpy(src), torch.from_numpy(lens),
                               cap_n=CAP, has_dict=False)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # decode with per-chunk dicts: chunk k's row j sees its own history
    out, csizes, _ = (g.numpy() for g in got)
    dbs = np.zeros((NC, B, 65536), np.uint8)
    dls = np.zeros((NC, B), np.int32)
    dbs[1, 0, -100:] = 7
    dls[1, 0] = 100
    want = jcorpus.decode_corpus(jnp.asarray(out), jnp.asarray(csizes),
                                 jnp.asarray(dbs), jnp.asarray(dls),
                                 cap_out=CAP, has_dict=True)
    got = corpus.decode_corpus(*(torch.from_numpy(a) for a in
                                 (out, csizes, dbs, dls)), cap_out=CAP,
                               has_dict=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2].any()
    assert got[0].numpy().reshape(NC * B, -1).tobytes() == b"".join(data)


@pytest.mark.parametrize("kw", [{}, {"n_cand": 8, "lazy": True},
                                {"lite": True}, {"dict": True}])
def test_encode_blocks_host_matches_jax(kw):
    kw = dict(kw)
    prefixes = [gen_text(5000, seed=9)] * 3 if kw.pop("dict", False) \
        else None
    blocks = [gen_text(3000, seed=i) for i in range(3)]
    got = encode_sortscan.encode_blocks_host(blocks, prefixes, device="cpu",
                                             **kw)
    assert got == encode_jax.encode_blocks_host(blocks, prefixes, **kw)
    assert [blockcodec.decompress(c, 3000, dict_prefix=d) for c, d in
            zip(got, prefixes or [None] * 3)] == blocks


def test_serial_switches_route_to_sortscan(monkeypatch):
    """serial_decode / serial_encode off: <= 256 KB decodes and level <= 1
    encodes run the sort/scan codec (no B1 or B2 call), larger decodes
    under "device" go to the host; the default routes are unchanged."""
    calls = []
    for name in ("decode_blocks", "encode_blocks"):
        orig = getattr(tengine, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tengine, name, spy)
    blocks = [gen_text(20_000, seed=40), gen_buffer(9000, 0.7, seed=41)]
    be = TorchBackend("cpu")
    be.wave_decode = False
    comp = be.compress_batch(blocks)
    assert be.decompress_batch(comp, [65536] * 2) == blocks
    assert calls == ["encode_blocks", "decode_blocks"]
    be.serial_decode = be.serial_encode = False
    calls.clear()
    comp2 = be.compress_batch(blocks, acceleration=4)
    assert comp2 == encode_sortscan.encode_blocks_host(
        blocks, lite=True, device="cpu")
    assert be.decompress_batch(comp2, [65536] * 2) == blocks
    assert be.decompress_batch(comp, [65536] * 2) == blocks
    assert calls == [] and be.sortscan_decoded == 2
    bad = [comp[0][: len(comp[0]) // 2], comp[1]]
    with pytest.raises(BlockDecodeError):
        be.decompress_batch(bad, [65536] * 2)
    assert be.compress_batch(blocks, level=3) == \
        TorchBackend("cpu")._host().compress_batch(blocks, level=3)
    assert be.hc_encoded == 0
