"""B5's plain version (`encode_blocks_hc_plain`) against the JAX kernel
`encode_blocks_hc_pallas` in interpret mode, and against the host C lazy
tier (the port's `compress_lazy`, and `compress_hc` at levels 3-9) on
more seeds. Tolerance: exact (LZ4 streams are deterministic bytes).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu.block.encode_hc_pallas import (K_DEPTH,  # noqa: E402
                                            encode_blocks_hc_pallas)
from lz4_tpu_torch.block import encode_hc  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_text,  # noqa: E402
                                         mixed_corpus)


def _corpus(n):
    """tests/test_encode_hc_pallas.py's corpus at length n."""
    return [gen_text(n, seed=31), mixed_corpus(n, seed=32),
            gen_buffer(n, match_prob=0.97, seed=33), b"\x00" * n,
            b"abab" * (n // 8) + b"Q" + b"abab" * (n // 16),
            bytes(np.random.default_rng(34).integers(0, 256, n // 4,
                                                     dtype=np.uint8)),
            gen_text(200, seed=35), b"abcabcabcab", b""]


def _plain(blocks, cap, **kw):
    src, lens, _, _ = pack_blocks(blocks, cap=cap)
    out, cs, tr = encode_hc.encode_blocks_hc_plain(
        torch.from_numpy(src), torch.from_numpy(lens), cap_n=cap, **kw)
    return [out[i, :n].numpy().tobytes()
            for i, n in enumerate(cs.tolist())], tr.tolist()


@pytest.mark.parametrize("level,favor", [(3, False), (5, False), (9, False),
                                         (9, True)])
def test_plain_matches_jax_kernel(level, favor):
    blocks = _corpus(3000)
    cap = 3072
    src, lens, _, _ = pack_blocks(blocks, cap=cap)
    out, cs, tr = encode_blocks_hc_pallas(
        jnp.asarray(src), jnp.asarray(lens), cap_n=cap, level=level,
        interpret=True, favor_dec_speed=favor)
    out, cs, tr = np.asarray(out), np.asarray(cs), np.asarray(tr)
    want = [out[i, : cs[i]].tobytes() for i in range(len(blocks))]
    got, trail = _plain(blocks, cap, level=level, favor_dec_speed=favor)
    assert got == want
    assert trail == tr.tolist()


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_c_lazy_tier(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 12000))
    blocks = _corpus(n) + [gen_buffer(int(rng.integers(0, 9000)),
                                      float(rng.random()), seed=seed)]
    for level in range(3, 10):
        for favor in (False, True):
            got, _ = _plain(blocks, 16384, level=level,
                            favor_dec_speed=favor)
            for b, g in zip(blocks, got):
                assert g == blockcodec.compress_lazy(
                    b, encode_hc.depth_for(level), favor_dec_speed=favor)
                if not favor:
                    assert g == blockcodec.compress_hc(b, level)
                assert blockcodec.decompress(g, len(b)) == b


def test_plain_matches_compress_hc_at_64k():
    # a full 64 KB tier block, every routed depth on the same bytes
    block = gen_text(40000, seed=7) + gen_buffer(25536, 0.8, seed=8)
    for level in (3, 6, 9):
        got, trail = _plain([block], 65536, level=level)
        assert got[0] == blockcodec.compress_hc(block, level)
        assert trail[0] <= len(block)


def test_compress_lazy_matches_the_jax_package():
    blocks = _corpus(5000)
    for tries in (4, 64, 256):
        for b in blocks:
            assert blockcodec.compress_lazy(b, tries) == \
                jnative.blockcodec.compress_lazy(b, tries)


def test_depth_ladder_and_contract():
    assert tuple(encode_hc.K_DEPTH) == tuple(K_DEPTH)
    assert encode_hc.depth_for(-3) == K_DEPTH[0]
    assert encode_hc.depth_for(99) == K_DEPTH[12]
    src = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cap_n"):
        encode_hc.encode_blocks_hc(src, torch.zeros(2, dtype=torch.int32),
                                   cap_n=65537)
    with pytest.raises(ValueError, match="uint8"):
        encode_hc.encode_blocks_hc(src, torch.zeros(2, dtype=torch.int32),
                                   cap_n=128)
    # lengths are clamped into [0, cap_n]; an empty batch is fine
    row = gen_text(64, seed=3)
    src[0] = torch.frombuffer(bytearray(row), dtype=torch.uint8)
    out, cs, tr = encode_hc.encode_blocks_hc(
        src, torch.tensor([1000, -5], dtype=torch.int32), cap_n=64)
    assert out[0, : cs[0]].numpy().tobytes() == blockcodec.compress_hc(row, 9)
    assert cs[1] == 1 and tr.tolist()[1] == 0
    out, cs, tr = encode_hc.encode_blocks_hc(
        torch.zeros((0, 64), dtype=torch.uint8),
        torch.zeros(0, dtype=torch.int32), cap_n=64)
    assert out.shape == (0, 80) and cs.shape == (0,)


def test_cpu_calls_launch_nothing_and_caps_follow_the_parts():
    """CPU tensors run the plain version: neither B5 counter moves. The
    model's list capacities at 128 and 256 parts are the C launcher's
    (a quarter of a part's positions plus 128; 256 a repair)."""
    n, c = encode_hc.launches, encode_hc.cluster_launches
    row = gen_text(3000, seed=4)
    src = torch.frombuffer(bytearray(row), dtype=torch.uint8)[None, :]
    out, cs, _ = encode_hc.encode_blocks_hc(
        src, torch.tensor([3000], dtype=torch.int32), cap_n=3000)
    assert out[0, : cs[0]].numpy().tobytes() == blockcodec.compress_hc(row, 9)
    assert (encode_hc.launches, encode_hc.cluster_launches) == (n, c)
    assert encode_hc.segment_caps(65536) == (256, 256)
    assert encode_hc.segment_caps(65536, encode_hc.PAIR_SEGMENTS) == (192, 256)
    assert encode_hc.PAIR_SEGMENTS == 2 * encode_hc.SEGMENTS
