"""The staging of a host encode call on the CPU: `pack_into` writes every
byte of rows that held anything before, so they equal `pack_blocks`'
zero-padded rows, and a `TorchBackend` on the CPU stages nothing in
page-locked memory. The staged path itself runs on the card
(tests/test_torch_cuda.py). Tolerance: exact."""
import numpy as np
import pytest

from lz4_tpu_torch.block.batch import DICT_CAP, pack_blocks, pack_into
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text


def _blocks():
    rng = np.random.default_rng(7)
    return [gen_text(5000, seed=1), b"", rng.bytes(4096), b"q",
            gen_buffer(4095, 0.6, seed=2), b"\x00" * 300]


PREFIXES = [
    None,
    [gen_text(70000, seed=3), None, b"", b"xy", gen_text(900, seed=4)],
    [gen_text(DICT_CAP, seed=5)] * 6,
]


@pytest.mark.parametrize("prefixes", PREFIXES)
@pytest.mark.parametrize("cap", [5000, 8192])
def test_pack_into_dirty_arrays_equals_pack_blocks(prefixes, cap):
    blocks = _blocks()
    with_dict = prefixes is not None
    want = pack_blocks(blocks, prefixes, cap=cap, with_dict=with_dict)
    dirty = [None if a is None else np.full_like(a, 0xAB) for a in want]
    pack_into(blocks, prefixes, *dirty)
    for got, ref in zip(dirty, want):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_pack_blocks_zero_pads_and_aligns():
    src, lens, db, dl = pack_blocks([b"abc", b""], [b"hist", None], cap=8,
                                    with_dict=True)
    assert src.tolist() == [list(b"abc") + [0] * 5, [0] * 8]
    assert lens.tolist() == [3, 0] and dl.tolist() == [4, 0]
    assert db[0, -4:].tobytes() == b"hist" and not db[0, :-4].any()
    assert not db[1].any()


def test_pack_into_refuses_a_block_over_cap():
    src, lens = np.zeros((1, 4), np.uint8), np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="> cap 4"):
        pack_into([b"12345"], None, src, lens)


def test_cpu_backend_stages_nothing():
    data = gen_text(150000, seed=8)
    blocks = [data[i: i + 5000] for i in range(0, 20000, 5000)]
    be = TorchBackend("cpu", min_device_size=16)
    for level in (1, 2, 9):
        be.compress_batch(blocks, level=level)
    be.compress_batch(blocks, level=1, dict_prefixes=[data[:9000]] * 4)
    be.compress_batch([data[:70000]], level=1)
    assert be.hc_encoded == 1 and be.device_hc_encoded == 1
    assert be.pinned_calls == 0
