"""The batch frame surfaces (`lz4_tpu_torch.frame.batch`) on the CPU:
`compress_frames_wave` byte-identical to the JAX surface's, and
`decompress_frames_wave` held to the JAX package's sequential decoder
(`lz4_tpu.frame.reader.decompress_frame`), not to the JAX batch surface,
which has the two faults this module's docstring names. Tolerance: exact.
"""
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from lz4_tpu.frame import batch as jbatch  # noqa: E402
from lz4_tpu.frame.reader import decompress_frame as j_decompress  # noqa: E402
from lz4_tpu_torch.block.backend import BlockDecodeError  # noqa: E402
from lz4_tpu_torch.frame import batch as tbatch  # noqa: E402
from lz4_tpu_torch.frame.format import (FrameError, FrameInfo,  # noqa: E402
                                        Preferences, header_size,
                                        parse_frame_header,
                                        write_frame_header)
from lz4_tpu_torch.frame.writer import compress_frame  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _payloads():
    rng = np.random.default_rng(4)
    return [gen_text(100000, seed=1), gen_buffer(70000, 0.7, seed=2),
            rng.bytes(5000), b"\x07" * 65536]


def _rewrite_header(frame: bytes, **changes) -> bytes:
    """The same frame under another header (blocks untouched)."""
    info, used = parse_frame_header(frame[: header_size(frame)])
    for k, v in changes.items():
        setattr(info, k, v)
    return write_frame_header(info) + frame[used:]


@pytest.mark.parametrize("independent", [False, True])
def test_compress_frames_wave_vs_jax(independent):
    datas = _payloads()
    ours = tbatch.compress_frames_wave(datas, block_independent=independent,
                                       device="cpu")
    assert ours == jbatch.compress_frames_wave(
        datas, block_independent=independent, interpret=True)
    for f, d in zip(ours, datas):
        assert j_decompress(f) == d


def test_decompress_frames_wave_vs_sequential():
    datas = _payloads()
    frames = (tbatch.compress_frames_wave(datas, device="cpu")
              + tbatch.compress_frames_wave(datas[:2], block_independent=True,
                                            device="cpu"))
    be = TorchBackend(device="cpu")
    checked = compress_frame(datas[1], prefs=Preferences(
        frame_info=FrameInfo(block_size_id=4, block_checksum=True,
                             block_independent=False)), backend=be)
    big = compress_frame(datas[0], prefs=Preferences(
        frame_info=FrameInfo(block_size_id=5)), backend=be)
    frames += [checked, big]
    before = tbatch.sequential_fallbacks
    ours = tbatch.decompress_frames_wave(frames, device="cpu")
    assert ours == [j_decompress(f) for f in frames]
    # only the 256 KB-block frame and the frame holding a stored block
    # (the random payload) leave the wave tier
    assert tbatch.sequential_fallbacks - before == 2


def test_corrupt_content_checksum_raises():
    f = bytearray(tbatch.compress_frames_wave([gen_text(9000, seed=3)],
                                              device="cpu")[0])
    f[-1] ^= 0x55
    with pytest.raises(FrameError, match="contentChecksum"):
        tbatch.decompress_frames_wave([bytes(f)], device="cpu")


def test_independent_frame_crossing_a_block_raises():
    """A frame that says its blocks are independent but whose second
    block copies from the first is malformed. The JAX surface decodes it
    silently (its fault: lz4_tpu/frame/batch.py:135 with
    decode_wave.py:417 decode independent frames as linked); the port
    rejects it in the splitter, and the sequential decoder raises."""
    data = gen_text(65536, seed=6) * 2
    linked = tbatch.compress_frames_wave([data], device="cpu")[0]
    forged = _rewrite_header(linked, block_independent=True)
    assert jbatch.decompress_frames_wave([forged], interpret=True) == [data]
    with pytest.raises(ValueError):            # its sequential decoder
        j_decompress(forged)
    before = tbatch.sequential_fallbacks
    with pytest.raises(BlockDecodeError):
        tbatch.decompress_frames_wave([forged], device="cpu")
    assert tbatch.sequential_fallbacks == before + 1


def test_dict_id_frame_is_not_wave_decoded():
    data = gen_text(30000, seed=8)
    plain = tbatch.compress_frames_wave([data], block_independent=True,
                                        device="cpu")[0]
    with_id = _rewrite_header(plain, dict_id=7)
    assert struct.unpack_from("<I", with_id, 6)[0] == 7
    before = tbatch.sequential_fallbacks
    assert tbatch.decompress_frames_wave([with_id], device="cpu") == \
        [j_decompress(with_id)] == [data]
    assert tbatch.sequential_fallbacks == before + 1
