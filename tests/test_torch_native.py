"""The port's host C tier (`lz4_tpu_torch.native`) against the JAX
package's (`lz4_tpu.native`), byte for byte, on the same inputs: the wave
splitter and emitter, XXH32 and the block codecs. Also `HostBackend` and
the loader's failure path. Tolerance: exact.
"""
import numpy as np
import pytest

from lz4_tpu import native as jnative
from lz4_tpu.block.encode_wave import emit_from_decisions as j_emit
from lz4_tpu.xxh32 import _xxh32_py
from lz4_tpu_torch import native
from lz4_tpu_torch.block.backend import BlockDecodeError, HostBackend
from lz4_tpu_torch.block.encode_wave import (emit_from_decisions,
                                             find_matches_batch)
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text
from lz4_tpu_torch.xxh32 import XXH32State, xxh32, xxh32_plain

JBC = jnative.blockcodec
TBC = native.blockcodec


def _sources():
    rng = np.random.default_rng(3)
    return [gen_text(5000, seed=1), gen_buffer(9000, 0.7, seed=2),
            b"\x00" * 7000, rng.bytes(3000), b"A", b"ab" * 4000,
            gen_text(65536, seed=4), bytes(range(256)) * 40]


def _streams():
    srcs = _sources()
    return ([JBC.compress(s) for s in srcs]
            + [JBC.compress_hc(s, 9) for s in srcs]
            + [JBC.compress_maxd(s, 2048) for s in srcs])


def _mutated(streams, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cc = bytearray(streams[k % len(streams)])
        if len(cc) > 1 and rng.random() < 0.5:
            cc = cc[: int(rng.integers(1, len(cc)))]
        for _ in range(int(rng.integers(1, 4))):
            cc[int(rng.integers(0, len(cc)))] = int(rng.integers(0, 256))
        out.append(bytes(cc))
    return out + [b"", b"\x00", b"\x10", b"\x40abcd\x00\x00\x00"]


@pytest.mark.parametrize("hist_len", [0, 65536])
def test_wave_split_parity(hist_len):
    streams = _streams()
    cases = streams + _mutated(streams, 60, seed=hist_len)
    accepted = 0
    for c in cases:
        for out_cap in (65536, 4096):
            a = JBC.wave_split(c, max_pieces=64, out_cap=out_cap,
                               hist_len=hist_len)
            b = TBC.wave_split(c, max_pieces=64, out_cap=out_cap,
                               hist_len=hist_len)
            assert (a is None) == (b is None)
            if a is not None:
                accepted += 1
                assert b[1] == a[1]
                np.testing.assert_array_equal(b[0], a[0])
    assert accepted >= len(streams)


@pytest.fixture(params=[32, 2], ids=["one_span", "spans"])
def span_rows(request, monkeypatch):
    """Rows per host thread in the batch calls: 2 runs a test's batch
    as several C calls at once."""
    monkeypatch.setattr(native, "SPAN_ROWS", request.param)
    return request.param


def test_spans_cover_the_batch(monkeypatch):
    monkeypatch.setattr(native.os, "cpu_count", lambda: 4)
    assert native._spans(0) == [(0, 0)]
    assert native._spans(40) == [(0, 40)]
    assert native._spans(100) == [(0, 34), (34, 68), (68, 100)]
    assert native._spans(768) == [(0, 192), (192, 384), (384, 576),
                                  (576, 768)]


def test_wave_split_batch_parity(span_rows):
    streams = _streams()
    caps = [65536] * len(streams)
    a = JBC.wave_split_batch(streams, max_pieces=64, out_caps=caps)
    b = TBC.wave_split_batch(streams, max_pieces=64, out_caps=caps)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    bad = streams[:3] + [streams[3][:-2]]
    assert JBC.wave_split_batch(bad, max_pieces=64) is None
    assert TBC.wave_split_batch(bad, max_pieces=64) is None
    bad = streams + [streams[3][:-2]]          # rejected in the last span
    assert TBC.wave_split_batch(bad, max_pieces=64) is None


def test_wave_emit_parity(span_rows):
    blocks = _sources()
    for max_dist in (2048, 65535):
        dec = find_matches_batch(blocks, max_dist=max_dist, device="cpu")
        ours = TBC.wave_emit_decisions(blocks, dec)
        assert ours == JBC.wave_emit_decisions(blocks, dec)
        assert ours == [emit_from_decisions(b, dec[i])
                        for i, b in enumerate(blocks)]
        assert ours == [j_emit(b, dec[i]) for i, b in enumerate(blocks)]
        assert TBC.decompress_batch(ours, [65536] * len(blocks)) == blocks


def test_xxh32_parity():
    rng = np.random.default_rng(9)
    for n in (0, 1, 3, 4, 15, 16, 17, 31, 100, 1000, 65536 + 7):
        data = rng.bytes(n)
        for seed in (0, 1, 0x9E3779B1, 0xFFFFFFFF):
            want = _xxh32_py(data, seed)
            assert xxh32(data, seed) == want
            assert xxh32_plain(data, seed) == want
            assert jnative.xxh.xxh32(data, seed) == want
    data = rng.bytes(4096)
    accs = [1, 2, 3, 0xFFFFFFFF]
    assert native.xxh.xxh32_rounds(data, accs) == \
        jnative.xxh.xxh32_rounds(data, accs)
    st = XXH32State(5)
    for k in range(0, len(data), 37):
        st.update(data[k: k + 37])
    assert st.digest() == _xxh32_py(data, 5)


def test_block_codec_parity():
    srcs = _sources()
    hist = gen_text(80000, seed=12)
    for s in srcs:
        assert TBC.compress(s) == JBC.compress(s)
        assert TBC.compress(s, acceleration=8) == \
            JBC.compress(s, acceleration=8)
        assert TBC.compress(s, dict_prefix=hist) == \
            JBC.compress(s, dict_prefix=hist)
        assert TBC.compress_maxd(s, 1024) == JBC.compress_maxd(s, 1024)
        for level in (3, 9, 12):
            assert TBC.compress_hc(s, level) == JBC.compress_hc(s, level)
        c = TBC.compress(s, dict_prefix=hist)
        assert TBC.decompress(c, len(s), dict_prefix=hist) == s
    comp = TBC.compress_batch(srcs)
    assert comp == JBC.compress_batch(srcs)
    assert TBC.decompress_batch(comp, [65536] * len(srcs)) == srcs
    with pytest.raises(BlockDecodeError):
        TBC.decompress(comp[0][:-3], 65536)
    with pytest.raises(BlockDecodeError):
        TBC.decompress_batch([comp[0], comp[1][:-3]], [65536, 65536])


def test_host_backend():
    be = HostBackend()
    srcs = _sources()
    hist = gen_text(70000, seed=2)
    assert be.compress_batch(srcs) == JBC.compress_batch(srcs)
    assert be.compress_batch(srcs[:1]) == [JBC.compress(srcs[0])]
    hc = be.compress_batch(srcs[:3], level=9)
    assert hc == [JBC.compress_hc(s, 9) for s in srcs[:3]]
    capped = be.compress_batch(srcs, max_dist=777, acceleration=2,
                               dict_prefixes=[hist] * len(srcs))
    assert capped == [JBC.compress_maxd(s, 777, acceleration=2,
                                        dict_prefix=hist) for s in srcs]
    assert be.decompress_batch(capped, [65536] * len(srcs),
                               dict_prefixes=[hist] * len(srcs)) == srcs
    with pytest.raises(ValueError, match="fast tier"):
        be.compress_batch(srcs, level=3, max_dist=2048)


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\necho 'error: no C compiler here' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="no C compiler here"):
        native.load()
    with pytest.raises(RuntimeError, match="C build failed"):
        xxh32(b"abc")
    assert not any((tmp_path / "build").glob("*.so*"))
    monkeypatch.setenv("CC", str(tmp_path / "missing-cc"))
    with pytest.raises(RuntimeError, match="C build failed"):
        native.load()
