"""The port's small host surfaces against the JAX package's: XXH64 (C
one-shot and Python streaming), `compress_destsize`, and the one-shot
`compress` / `decompress`, on the same numpy-seeded inputs. Tolerance:
exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lz4_tpu  # noqa: E402
from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu import xxh64 as jxxh64  # noqa: E402
from lz4_tpu.block import backend as jbackend  # noqa: E402
import lz4_tpu_torch  # noqa: E402
from lz4_tpu_torch import native  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.frame.format import FrameInfo, Preferences  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_text,  # noqa: E402
                                         mixed_corpus)
from lz4_tpu_torch.xxh64 import XXH64State, xxh64  # noqa: E402

SIZES = [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4096, 70001]


def test_xxh64_public_vector():
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert XXH64State().digest() == 0xEF46DB3751D8E999
    assert lz4_tpu_torch.xxh64 is xxh64


@pytest.mark.parametrize("n", SIZES)
def test_xxh64_matches_jax(n):
    rng = np.random.default_rng(n)
    data = rng.bytes(n)
    for seed in [0, *(int.from_bytes(rng.bytes(8), "little")
                      for _ in range(3))]:
        want = jxxh64.XXH64State(seed).update(data).digest()
        assert xxh64(data, seed) == want == jxxh64.xxh64(data, seed)
        assert XXH64State(seed).update(data).digest() == want


def test_xxh64_streaming_equals_one_shot():
    rng = np.random.default_rng(11)
    data = rng.bytes(100_000)
    st = XXH64State(12345)
    i = 0
    while i < len(data):
        step = int(rng.integers(1, 7000))
        st.update(data[i: i + step])
        i += step
    assert st.digest() == xxh64(data, 12345)
    assert st.reset().update(data).digest() == xxh64(data, 12345)


def _destsize_inputs():
    rng = np.random.default_rng(5)
    return [gen_text(70000, seed=1), gen_buffer(65536, 0.7, seed=2),
            rng.bytes(20000), b"\x00" * 50000, b"", b"abc"]


@pytest.mark.parametrize("cap", [1, 16, 100, 1000, 16384, 70000])
def test_compress_destsize_matches_jax(cap):
    for data in _destsize_inputs():
        got = native.blockcodec.compress_destsize(data, cap)
        assert got == jnative.blockcodec.compress_destsize(data, cap)
        comp, consumed = got
        assert len(comp) <= cap
        if consumed:
            assert native.blockcodec.decompress(comp, len(data)) == \
                data[:consumed]


ONE_SHOT = [
    (1, {}),
    (2, {}),
    (9, {}),
    (1, {"store_content_size": True}),
    (9, {"store_content_size": True}),
]


@pytest.mark.parametrize("level,kw", ONE_SHOT,
                         ids=[f"l{lv}-{'size' if kw else 'plain'}"
                              for lv, kw in ONE_SHOT])
def test_one_shot_matches_jax(level, kw):
    """lz4_tpu_torch.compress on the host tier writes lz4_tpu.compress's
    bytes, and each package's decompress reads the other's frames."""
    data = mixed_corpus(300000, seed=level)
    port = lz4_tpu_torch.compress(data, level, backend=HostBackend(), **kw)
    ref = lz4_tpu.compress(data, level, backend=jbackend.HostBackend(), **kw)
    assert port == ref
    assert lz4_tpu_torch.decompress(ref, backend=HostBackend()) == data
    assert lz4_tpu.decompress(port, backend=jbackend.HostBackend()) == data


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("independent", [True, False],
                         ids=["indep", "linked"])
def test_one_shot_on_torch_backend_cpu(level, independent):
    """The one-shot surfaces on TorchBackend("cpu") (the kernels' plain
    versions): the round trip holds and the frames decode through both
    packages' host tiers."""
    be = TorchBackend("cpu")
    data = mixed_corpus(150000, seed=3)
    prefs = Preferences(frame_info=FrameInfo(block_size_id=4,
                                             block_independent=independent))
    frame = lz4_tpu_torch.compress(data, level, prefs=prefs, backend=be)
    assert lz4_tpu_torch.decompress(frame, backend=be) == data
    assert lz4_tpu_torch.decompress(frame, backend=HostBackend()) == data
    assert lz4_tpu.decompress(frame, backend=jbackend.HostBackend()) == data


def test_xxh64_raises_without_a_compiler(monkeypatch, tmp_path):
    """No Python fallback: a failed C build raises."""
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="C build failed"):
        xxh64(b"abc")
