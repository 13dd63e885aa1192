"""B6's plain version (`xxh32_blocks_plain`) against the JAX package's
`xxh32_blocks` (XLA scan), `xxh32_blocks_pallas` (interpret mode) and
`lz4_tpu.xxh32.xxh32`, on the same seeded batches. Tolerance: exact.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu.xxh32 import xxh32 as jxxh32  # noqa: E402
from lz4_tpu.xxh32_device import (xxh32_blocks as jax_blocks,  # noqa: E402
                                  xxh32_blocks_pallas)
from lz4_tpu_torch import xxh32_device  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer  # noqa: E402

CASES = [b"", b"a", b"abc", b"0123456789abcde", b"0123456789abcdef",
         b"0123456789abcdef0", gen_buffer(1000, seed=1),
         gen_buffer(4096, seed=2), gen_buffer(4095, seed=3),
         gen_buffer(4093, seed=4)]


def _random_rows(seed, cap, count=24):
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(0, cap + 1, count)) + [0, 15, 16, 17, cap]
    return [rng.bytes(int(n)) for n in lens if n <= cap]


def _plain(rows, cap, seed):
    data, lens, _, _ = pack_blocks(rows, cap=cap)
    return xxh32_device.xxh32_blocks(torch.from_numpy(data),
                                     torch.from_numpy(lens), seed,
                                     cap=cap).tolist()


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 0xFFFFFFFF])
def test_plain_matches_scan_and_host(seed):
    cap = 4096
    for rows in (CASES, _random_rows(seed & 0xFFFF, cap)):
        data, lens, _, _ = pack_blocks(rows, cap=cap)
        want = np.asarray(jax_blocks(jnp.asarray(data), jnp.asarray(lens),
                                     seed, cap=cap)).tolist()
        assert _plain(rows, cap, seed) == want
        assert want == [jxxh32(r, seed) for r in rows]


def test_plain_matches_pallas_kernel():
    cap = 4096
    rows = CASES + _random_rows(7, cap)
    data, lens, _, _ = pack_blocks(rows, cap=cap)
    want = np.asarray(xxh32_blocks_pallas(
        jnp.asarray(data), jnp.asarray(lens), 0, cap=cap,
        interpret=True)).tolist()
    assert _plain(rows, cap, 0) == want


@pytest.mark.parametrize("cap", [16, 48, 1040])
def test_caps_that_are_multiples_of_16(cap):
    rows = _random_rows(cap, cap)
    got = _plain(rows, cap, 0xFFFFFFFF)
    assert got == [jxxh32(r, 0xFFFFFFFF) for r in rows]
    assert all(0 <= h < 1 << 32 for h in got)


def test_contract():
    data = torch.zeros((3, 64), dtype=torch.uint8)
    lens = torch.zeros(3, dtype=torch.int32)
    assert xxh32_device.xxh32_blocks(data, lens, cap=64).dtype == torch.int64
    with pytest.raises(ValueError, match="multiple of 16"):
        xxh32_device.xxh32_blocks(data[:, :40].contiguous(), lens, cap=40)
    with pytest.raises(ValueError, match="multiple of 16"):
        xxh32_device.xxh32_blocks(data, lens, cap=32)
    with pytest.raises(TypeError, match="int32"):
        xxh32_device.xxh32_blocks(data, lens.long(), cap=64)
    with pytest.raises(ValueError, match="seed"):
        xxh32_device.xxh32_blocks(data, lens, 1 << 32, cap=64)
    with pytest.raises(ValueError, match="contiguous"):
        xxh32_device.xxh32_blocks(data.t().contiguous().t(), lens, cap=64)
