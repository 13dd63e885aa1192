"""B6's schedule modelled on the CPU (`XXH32SplitModel`: rows to lane
groups, accumulators to lanes, chunks through a ring of stages filled by a
copy warp, the tail read from the ring, the shuffle merge) against B6's
plain version, the JAX package's XLA scan, `xxh32_blocks_pallas` in
interpret mode and `lz4_tpu.xxh32.xxh32`; and the port's host
`xxh32_batch` against the JAX package's. Inputs are made from numpy
seeds. Tolerance: exact.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu.xxh32 import xxh32 as jxxh32  # noqa: E402
from lz4_tpu.xxh32 import xxh32_batch as jax_xxh32_batch  # noqa: E402
from lz4_tpu.xxh32_device import (xxh32_blocks as jax_blocks,  # noqa: E402
                                  xxh32_blocks_pallas)
from lz4_tpu_torch import xxh32_device  # noqa: E402
from lz4_tpu_torch.probes import b6_split  # noqa: E402
from lz4_tpu_torch.xxh32 import xxh32_batch  # noqa: E402
from lz4_tpu_torch.xxh32_device import (XXH32SplitModel,  # noqa: E402
                                        xxh32_blocks_plain)

SEEDS = [0, 1, 0xDEADBEEF, 0xFFFFFFFF]
KERNEL = (pathlib.Path(xxh32_device.__file__).parent / "csrc" / "xxh32.cu")


def _boundary_lens(cap, stage):
    """Lengths just before, on and just after the stripe and stage
    boundaries that fit in cap, and 0, 15 and cap."""
    out = {0, 15, cap}
    for edge in (16, 32, stage, 2 * stage, cap - 16):
        out.update(e for e in (edge - 1, edge, edge + 1) if 0 <= e <= cap)
    return sorted(out)


def _batch(seed, cap, stage=xxh32_device.STAGE_BYTES, extra=5):
    """uint8[B, cap] and int32[B]: every boundary length and `extra`
    random ones, B not a multiple of 8 (one row dropped if it is)."""
    rng = np.random.default_rng(seed & 0xFFFF)
    lens = _boundary_lens(cap, stage) + list(
        rng.integers(0, cap + 1, extra))
    if len(lens) % 8 == 0:
        lens = lens[:-1]
    data = rng.integers(0, 256, (len(lens), cap), dtype=np.uint8)
    return data, np.array(lens, dtype=np.int32)


def _host(data, lens, seed):
    return [jxxh32(data[i, : lens[i]].tobytes(), seed)
            for i in range(len(lens))]


def _plain(data, lens, seed):
    return xxh32_blocks_plain(torch.from_numpy(data), torch.from_numpy(lens),
                              seed, cap=data.shape[1]).tolist()


@pytest.mark.parametrize("cap", [16, 48, 1040, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_model_matches_plain_scan_and_host(seed, cap):
    data, lens = _batch(seed, cap)
    got = XXH32SplitModel(seed=seed & 7).hash(data, lens, seed).tolist()
    scan = np.asarray(jax_blocks(jnp.asarray(data), jnp.asarray(lens), seed,
                                 cap=cap)).tolist()
    assert got == _plain(data, lens, seed) == scan == _host(data, lens, seed)


@pytest.mark.parametrize("cap", [32, 4096])
@pytest.mark.parametrize("seed", [0, 0xDEADBEEF])
def test_model_matches_pallas_kernel(seed, cap):
    data, lens = _batch(seed + 1, cap, extra=3)
    want = np.asarray(xxh32_blocks_pallas(
        jnp.asarray(data), jnp.asarray(lens), seed, cap=cap,
        interpret=True)).tolist()
    assert XXH32SplitModel().hash(data, lens, seed).tolist() == want


def test_model_rows_of_64k():
    cap = 65536
    lens = np.array([cap, cap - 1, 2 * 2048 + 17], dtype=np.int32)
    data = np.random.default_rng(64).integers(0, 256, (3, cap),
                                              dtype=np.uint8)
    for seed in (0, 0xFFFFFFFF):
        got = XXH32SplitModel().hash(data, lens, seed).tolist()
        assert got == _plain(data, lens, seed) == _host(data, lens, seed)
    scan = np.asarray(jax_blocks(jnp.asarray(data), jnp.asarray(lens), 0,
                                 cap=cap)).tolist()
    assert scan == XXH32SplitModel().hash(data, lens, 0).tolist()


@pytest.mark.parametrize("stage,stages", [(16, 1), (48, 3), (64, 2),
                                          (2048, 1)])
def test_small_rings_every_schedule(stage, stages):
    """Rings of few, small stages, so each row wraps the ring many times;
    several scheduler seeds interleave the copy warp, the copies in flight
    and the hashing warp differently."""
    for seed in (0, 0xDEADBEEF):
        data, lens = _batch(stage + seed, 4096, stage=stage)
        want = _host(data, lens, seed)
        for sched in range(3):
            model = XXH32SplitModel(stage, stages, seed=sched)
            assert model.hash(data, lens, seed).tolist() == want


@pytest.mark.parametrize("B", [1, 7, 8, 9, 17])
def test_copies_cover_each_row_once(B):
    """The copies of a row cover [0, ceil16(n)) in order, each at most a
    stage, and nothing past it: never past the row."""
    cap = 4096
    rng = np.random.default_rng(B)
    lens = rng.integers(0, cap + 1, B).astype(np.int32)
    lens[0] = cap
    data = rng.integers(0, 256, (B, cap), dtype=np.uint8)
    model = XXH32SplitModel(1024, 2, seed=B)
    assert model.hash(data, lens).tolist() == _host(data, lens, 0)
    for b in range(B):
        mine = [(off, nb) for row, off, nb in model.copies if row == b]
        end = 0
        for off, nb in mine:
            assert off == end and 0 < nb <= 1024 and nb % 16 == 0
            end += nb
        assert end == -(-int(lens[b]) // 16) * 16


def test_layout_matches_the_kernel_source():
    src = KERNEL.read_text()
    for name, value in (("kLanesPerRow", xxh32_device.LANES_PER_ROW),
                        ("kStageBytes", xxh32_device.STAGE_BYTES),
                        ("kStages", xxh32_device.STAGES),
                        ("kRingPad", xxh32_device.RING_PAD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert [xxh32_device.grid_for(B) for B in (1, 7, 8, 9, 768)] == \
        [1, 1, 1, 2, 96]
    assert xxh32_device.P1 * xxh32_device.P1_INV % (1 << 32) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_host_batch_matches_reference(seed):
    data, lens = _batch(seed, 1040)
    got = xxh32_batch(data, lens, seed)
    assert got.dtype == np.uint32
    assert got.tolist() == jax_xxh32_batch(data, lens, seed).tolist()
    assert got.tolist() == _host(data, lens, seed)
    assert xxh32_batch(data[:0], lens[:0]).shape == (0,)


def test_b6_probe_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b6_split.main([]) != 0
    assert capsys.readouterr().out == ""
