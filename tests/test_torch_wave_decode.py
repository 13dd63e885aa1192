"""B3 (wave-arena decode): the port's plain PyTorch version against the
JAX package's `_wave_kernel` in interpret mode, on the same splitter
arenas, and `TorchBackend`'s wave decode route. Tolerance: exact (the
decoded bytes, up to each stream's out_len; bytes past it are
unspecified in both packages).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu.block import decode_wave as jdw  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu_torch.block import decode_cuda  # noqa: E402
from lz4_tpu_torch.block import decode_wave as tdw  # noqa: E402
from lz4_tpu_torch.block.backend import BlockDecodeError  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

BC = jnative.blockcodec


def _far(n, seed):
    """Data whose matches sit several KB back (the JAX kernel's far
    escape)."""
    rng = np.random.default_rng(seed)
    chunk = rng.bytes(3000)
    out = b""
    while len(out) < n:
        out += chunk + rng.bytes(2500) + gen_text(2000, seed=len(out))
    return out[:n]


def _both(streams, NP):
    """Split once, decode with both packages, assert parity."""
    arenas, out_lens = BC.wave_split_batch(streams, max_pieces=NP)
    want = jdw.wave_decode_batch(arenas, list(out_lens), interpret=True)
    ours = tdw.wave_decode_batch(arenas, out_lens, device="cpu")
    assert ours == want
    return ours


def test_mixed_and_hc_streams_np4():
    rng = np.random.default_rng(1)
    srcs = [gen_text(4096, seed=1), gen_buffer(3000, 0.7, seed=2),
            b"\x00" * 4096, rng.bytes(2000), b"Q", b"ab" * 2048,
            gen_buffer(4000, 0.95, seed=3)]
    streams = ([BC.compress(s) for s in srcs]
               + [BC.compress_hc(s, 9) for s in srcs]
               + [BC.compress(s, acceleration=8) for s in srcs])
    assert _both(streams, 4) == srcs * 3


def test_far_offsets_np16():
    srcs = [_far(16384, seed=s) for s in range(3)] + [
        gen_text(16384, seed=7), (b"0123456789abcdef" * 1024)]
    streams = [BC.compress(s) for s in srcs] + \
        [BC.compress_hc(s, 12) for s in srcs]
    assert _both(streams, 16) == srcs * 2


def test_one_piece_streams():
    srcs = [gen_text(n, seed=n) for n in (1, 13, 100, 700, 1024)]
    streams = [BC.compress(s) for s in srcs]
    arenas, out_lens = BC.wave_split_batch(streams, max_pieces=4)
    assert list(out_lens) == [len(s) for s in srcs]
    assert _both(streams, 4) == srcs


def test_linked_vs_jax():
    whole = [gen_text(65536 + 30000, seed=5),
             _far(65536, seed=6) + _far(65536, seed=6)[:20000]]
    streams = []
    for w in whole:
        b0, b1 = w[:65536], w[65536:]
        streams.append([BC.compress(b0), BC.compress(b1, dict_prefix=b0)])
    want = jdw.wave_decode_linked(streams, interpret=True)
    ours = tdw.wave_decode_linked(streams, device="cpu")
    assert ours == want == whole
    with pytest.raises(ValueError, match="non-final"):
        tdw.wave_decode_linked([[BC.compress(b"x" * 1000),
                                 BC.compress(b"y" * 10)]], device="cpu")


def test_plain_ring_history():
    # a match at position 0 reaching 50 KB into the history row
    hist = np.frombuffer(gen_text(65536, seed=8), np.uint8)
    blk = hist[-50000:-49000].tobytes() + b"tail" * 10
    comp = BC.compress(blk, dict_prefix=hist.tobytes())
    arena, n = BC.wave_split(comp, max_pieces=4, out_cap=4096,
                             hist_len=65536)
    arenas = np.zeros((1, 4, tdw.WCAP), np.uint8)
    arenas[0, : arena.shape[0]] = arena
    out = tdw.wave_decode(torch.from_numpy(arenas),
                          torch.tensor([n], dtype=torch.int32),
                          torch.from_numpy(hist.copy()[None]))
    assert out[0, :n].numpy().tobytes() == blk


@pytest.fixture
def tpu(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    return TpuBackend()


def test_backend_takes_wave_route(tpu):
    srcs = [gen_text(3000, seed=11), gen_buffer(4096, 0.6, seed=12),
            _far(4096, seed=13)]
    streams = [BC.compress(s) for s in srcs]
    be = TorchBackend(device="cpu")
    launches = decode_cuda.launches
    assert be.wave_decode
    ours = be.decompress_batch(streams, [4096] * len(srcs))
    assert be.wave_decoded == 1 and be.host_fallbacks == 0
    assert decode_cuda.launches == launches
    assert ours == tpu.decompress_batch(streams, [4096] * len(srcs)) == srcs
    # a dict batch stays on B2 (its plain version here)
    d = be.decompress_batch(streams[:1], [4096], dict_prefixes=[b"x" * 10])
    assert d == srcs[:1] and be.wave_decoded == 1
    be.wave_decode = False
    assert be.decompress_batch(streams, [4096] * len(srcs)) == srcs
    assert be.wave_decoded == 1


def test_backend_malformed_raises():
    src = gen_text(5000, seed=14)
    good = BC.compress(src)
    be = TorchBackend(device="cpu")
    for bad in (good[:-3], b"\x1fA\x00\x00", good[:40]):
        with pytest.raises(BlockDecodeError):
            be.decompress_batch([good, bad], [65536, 65536])
    with pytest.raises(BlockDecodeError):
        be.decompress_batch([good], [1000])          # over its cap
    assert be.host_fallbacks == 4 and be.wave_decoded == 0


def test_wave_decode_checks_its_arguments():
    a = torch.zeros((2, 4, tdw.WCAP), dtype=torch.uint8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tdw.wave_decode(a[:, :, :1000].contiguous(), n)
    with pytest.raises(TypeError):
        tdw.wave_decode(a, n.long())
    with pytest.raises(TypeError):
        tdw.wave_decode(a, n, torch.zeros((2, 100), dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        tdw.wave_decode(a.transpose(0, 1).contiguous().transpose(0, 1), n)
