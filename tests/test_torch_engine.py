"""The slice as a whole: `TorchBackend(device="cpu")` (the kernels' plain
versions) against the JAX package's `TpuBackend` on its serial Pallas
kernels (interpret mode: LZ4_TPU_PALLAS_CPU=1, LZ4_TPU_WAVE_DECODE=0),
and frames cross-decoded between the two packages. Tolerance: exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from lz4_tpu.frame import reader as jreader  # noqa: E402
from lz4_tpu.frame import writer as jwriter  # noqa: E402
from lz4_tpu.frame.format import FrameInfo, Preferences  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu_torch.block.backend import BlockDecodeError  # noqa: E402
from lz4_tpu_torch.frame import format as tformat  # noqa: E402
from lz4_tpu_torch.frame import reader as treader  # noqa: E402
from lz4_tpu_torch.frame import writer as twriter  # noqa: E402
from lz4_tpu_torch.parallel.engine import (TorchBackend,  # noqa: E402
                                           merge_segment_streams)
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


@pytest.fixture
def backends(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    monkeypatch.setenv("LZ4_TPU_WAVE_DECODE", "0")
    return TpuBackend(), TorchBackend(device="cpu")


def _blocks():
    rng = np.random.default_rng(1)
    return [gen_text(4096, seed=1), gen_buffer(9000, 0.7, seed=2),
            rng.bytes(12000), b"\x00" * 20000, gen_text(65536, seed=3)]


def test_compress_batch_parity(backends):
    tpu, port = backends
    blocks = _blocks()
    ours = port.compress_batch(blocks, level=1)
    assert ours == tpu.compress_batch(blocks, level=1)
    mx = [len(b) for b in blocks]
    assert port.decompress_batch(ours, mx) == blocks
    assert tpu.decompress_batch(ours, mx) == blocks


def test_compress_batch_dict_prefix_parity(backends):
    tpu, port = backends
    hist = gen_text(80000, seed=7)
    blocks = [gen_text(8000, seed=8), hist[-6000:-1000] + b"tail" * 500,
              gen_buffer(5000, 0.6, seed=9)]
    prefixes = [hist, hist[-3000:], None]
    ours = port.compress_batch(blocks, dict_prefixes=prefixes)
    assert ours == tpu.compress_batch(blocks, dict_prefixes=prefixes)
    mx = [65536] * len(blocks)
    assert port.decompress_batch(ours, mx, dict_prefixes=prefixes) == blocks
    assert tpu.decompress_batch(ours, mx, dict_prefixes=prefixes) == blocks


def test_big_block_segment_merge_parity(backends):
    tpu, port = backends
    block = gen_text(60000, seed=4) + gen_buffer(38304, 0.7, seed=5)  # 96 KB
    ours = port.compress_batch([block])
    assert ours == tpu.compress_batch([block])
    assert port.decompress_batch(ours, [1 << 18]) == [block]
    assert tpu.decompress_batch(ours, [1 << 18]) == [block]


def test_merge_segment_streams_all_literal_segments():
    # segments that are pure literals fold into one literal run
    src = bytes(range(256)) * 600
    port = TorchBackend(device="cpu")
    comp = port.compress_batch([src])[0]
    assert port.decompress_batch([comp], [len(src)]) == [src]
    assert merge_segment_streams(b"abc", [b"\x30abc"], [3]) == b"\x30abc"


def test_decompress_batch_raises(backends):
    _, port = backends
    good = port.compress_batch([gen_text(5000, seed=6)])[0]
    with pytest.raises(BlockDecodeError):
        port.decompress_batch([good[:-3]], [65536])
    with pytest.raises(BlockDecodeError):
        port.decompress_batch([good], [1000])        # over its cap
    with pytest.raises(NotImplementedError, match="A8"):
        port.compress_batch([good], level=9)


@pytest.mark.parametrize("independent", [True, False])
def test_frames_cross_decode(independent):
    port = TorchBackend(device="cpu")
    data = gen_text(150000, seed=31) + gen_buffer(60000, 0.7, seed=32)
    kw = dict(block_size_id=4, block_independent=independent,
              block_checksum=True, content_checksum=True)
    ours = twriter.compress_frame(
        data, prefs=tformat.Preferences(frame_info=tformat.FrameInfo(**kw)),
        backend=port)
    assert jreader.decompress_frame(ours) == data
    theirs = jwriter.compress_frame(
        data, prefs=Preferences(frame_info=FrameInfo(**kw)))
    assert treader.decompress_frame(theirs, backend=port) == data
    assert treader.decompress_frame(ours, backend=port) == data


def test_install_torch_backend_serves_frames():
    from lz4_tpu_torch.block import backend
    from lz4_tpu_torch.parallel.engine import install_torch_backend
    be = install_torch_backend("cpu")
    try:
        assert backend.default_backend() is be
        data = gen_text(90000, seed=51)
        frame = twriter.compress_frame(data)
        assert jreader.decompress_frame(frame) == data
        assert treader.decompress_frame(frame) == data
    finally:
        backend.set_default_backend(None)


def test_linked_big_block_frame_cross_decode():
    # 256 KB linked blocks: history dicts plus the segment merge
    port = TorchBackend(device="cpu")
    data = gen_text(300000, seed=41) + gen_buffer(250000, 0.7, seed=42)
    prefs = tformat.Preferences(frame_info=tformat.FrameInfo(
        block_size_id=5, block_independent=False, content_checksum=True))
    ours = twriter.compress_frame(data, prefs=prefs, backend=port)
    assert jreader.decompress_frame(ours) == data
    assert treader.decompress_frame(ours, backend=port) == data
