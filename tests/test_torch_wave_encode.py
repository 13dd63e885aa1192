"""B4 (the lockstep match finder): the port's plain PyTorch version
against the JAX package's `_encode_wave_kernel` in interpret mode, on the
same blocks, and the emitted bytes of the batch, linked and engine
routes. The port's decisions are [B, n_rows]; the JAX kernel's are
(n_rows, 128), compared as `.T[:B]`. Tolerance: exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu.block import encode_wave as jew  # noqa: E402
from lz4_tpu.block.backend import HostBackend as JHost  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu.utils.datagen import mixed_corpus  # noqa: E402
from lz4_tpu_torch.block import encode_cuda  # noqa: E402
from lz4_tpu_torch.block import encode_wave as tew  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

BC = jnative.blockcodec


def _blocks():
    rng = np.random.default_rng(21)
    return [gen_text(9000, seed=1), gen_buffer(7000, 0.7, seed=2),
            b"\x00" * 6000, rng.bytes(3000), b"Q", b"", b"abc" * 11,
            (b"0123456789abcdef" * 600)[:9000], gen_buffer(5000, 0.97, 3)]


@pytest.mark.parametrize("hash_bits,max_dist",
                         [(10, 2048), (9, 2048), (10, 1024), (9, 65535)])
def test_decisions_vs_jax(hash_bits, max_dist):
    blocks = _blocks()
    want = np.asarray(jew.find_matches_batch(
        blocks, interpret=True, max_dist=max_dist,
        hash_bits=hash_bits)).T[: len(blocks)]
    ours = tew.find_matches_batch(blocks, max_dist=max_dist,
                                  hash_bits=hash_bits, device="cpu")
    assert ours.dtype == np.int32 and ours.shape == want.shape
    np.testing.assert_array_equal(ours, want)
    assert (ours != 0).sum() > 100


def test_linked_vs_jax():
    # block 0 of stream 0 is short, so round 1 sees a partial history;
    # stream 2 ends early; max_dist 65535 > 4 * n_rows clamps the window
    t = gen_text(30000, seed=5)
    streams = [[t[:700], t[700:9000], t[9000:13000]],
               [t[13000:17096], t[5000:9096], t[:4096]],
               [gen_buffer(4096, 0.6, seed=7)]]
    for max_dist in (2048, 65535):
        n_rows = tew.rows_for(max(len(s[1]) for s in streams[:2]))
        wr = tew.history_rows(max_dist, n_rows)
        inp, lens = jew.pack_input([s[1] for s in streams[:2]], n_rows)
        hw, hl = jew.pack_history(streams[:2], 1, wr)
        want = np.asarray(jew._encode_wave_linked_raw(
            inp, lens, hw, hl, n_rows=n_rows, interpret=True,
            use_onehot=False, max_dist=max_dist,
            hash_bits=10)).T[:2]
        tinp, tlens = tew.pack_input([s[1] for s in streams[:2]], n_rows)
        hist, hlen = tew.pack_history(streams[:2], 1, wr)
        assert list(hlen) == [700, min(4096, wr * 4)]
        ours = tew.find_matches(*(torch.from_numpy(a) for a in
                                  (tinp, tlens, hist, hlen)),
                                max_dist=max_dist).numpy()
        np.testing.assert_array_equal(ours, want)
        got = tew.encode_wave_linked(streams, max_dist=max_dist,
                                     device="cpu")
        assert got == jew.encode_wave_linked(streams, interpret=True,
                                             max_dist=max_dist)
        for s, comps in zip(streams, got):
            hist_b = b""
            for raw, comp in zip(s, comps):
                assert BC.decompress(comp, len(raw),
                                     dict_prefix=hist_b or None) == raw
                hist_b += raw


def test_encode_wave_batch_bytes():
    blocks = _blocks()
    ours = tew.encode_wave_batch(blocks, max_dist=1500, device="cpu")
    assert ours == jew.encode_wave_batch(blocks, interpret=True,
                                         max_dist=1500)
    assert BC.decompress_batch(ours, [65536] * len(blocks)) == blocks


def test_python_and_c_emitters_agree():
    blocks = _blocks()
    dec = tew.find_matches_batch(blocks, device="cpu")
    py = [tew.emit_from_decisions(b, dec[i]) for i, b in enumerate(blocks)]
    assert tew.encode_wave_batch(blocks, device="cpu") == py
    assert tew.encode_wave_batch(blocks, device="cpu",
                                 emitter=lambda bs, d: [
                                     tew.emit_from_decisions(b, d[i])
                                     for i, b in enumerate(bs)]) == py


@pytest.fixture
def tpu(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    return TpuBackend()


def test_backend_max_dist_route(tpu):
    srcs = [mixed_corpus(30000 + 1000 * i, seed=90 + i) for i in range(4)]
    be = TorchBackend(device="cpu")
    assert be.wave_encode and tpu.wave_encode
    for accel in (1, 3):              # hash_bits 10, then 9
        ours = be.compress_batch(srcs, level=1, acceleration=accel,
                                 max_dist=2000)
        assert ours == tpu.compress_batch(srcs, level=1,
                                          acceleration=accel, max_dist=2000)
        assert be.decompress_batch(ours, [len(s) for s in srcs]) == srcs
    assert be.wave_encoded == 2 and be.wave_decoded == 2
    assert HostBackend().decompress_batch(ours, [65536] * 4) == srcs


def test_backend_max_dist_other_routes():
    srcs = [gen_text(20000, seed=31), gen_buffer(9000, 0.8, seed=32)]
    be = TorchBackend(device="cpu")
    hist = gen_text(70000, seed=33)
    # a dict batch goes to the host C capped codec
    d = be.compress_batch(srcs, max_dist=1024, dict_prefixes=[hist, None])
    assert d == JHost().compress_batch(srcs, max_dist=1024,
                                       dict_prefixes=[hist, None])
    with pytest.raises(ValueError, match="fast tier"):
        be.compress_batch(srcs, level=4, max_dist=1024)
    # wave_encode off: B1 (its plain version here) with its cap
    be.wave_encode = False
    launches = encode_cuda.launches
    b1 = be.compress_batch(srcs, max_dist=1024)
    assert be.wave_encoded == 0 and encode_cuda.launches == launches
    assert BC.decompress_batch(b1, [65536] * 2) == srcs
    arrays = [np.zeros((2, 65536), np.uint8), np.zeros(2, np.int32)]
    for i, s in enumerate(srcs):
        arrays[0][i, : len(s)] = np.frombuffer(s, np.uint8)
        arrays[1][i] = len(s)
    out, cs, _ = encode_cuda.encode_blocks_plain(
        *(torch.from_numpy(a) for a in arrays), cap_n=65536,
        max_dist=1024)
    assert b1 == [out[i, : cs[i]].numpy().tobytes() for i in range(2)]


def test_find_matches_checks_its_arguments():
    inp = torch.zeros((2, 4096), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    for hb in (0, 16):
        with pytest.raises(ValueError, match="hash_bits"):
            tew.find_matches(inp, lens, hash_bits=hb)
    with pytest.raises(TypeError):
        tew.find_matches(inp[:, :4095].contiguous(), lens)
    with pytest.raises(ValueError, match="64 KB"):
        tew.find_matches(torch.zeros((1, 262144), dtype=torch.uint8),
                         lens[:1])
    with pytest.raises(ValueError, match="together"):
        tew.find_matches(inp, lens, torch.zeros((2, 16), dtype=torch.uint8))
