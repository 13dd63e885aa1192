"""`TorchBackend(device="cpu")`'s HC routes and size gates against the JAX
package's `TpuBackend` (LZ4_TPU_PALLAS_CPU=1: its Pallas kernels in
interpret mode) and host tier. Levels 3-9 of no-dict batches of 4-64 KB
blocks run B5 (its plain version here); level 2 runs the sort/scan
encoder (the JAX package's `encode_jax` graphs in `TpuBackend`);
everything else goes to the host C tier, as in `TpuBackend`. Tolerance:
exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from lz4_tpu.block.backend import HostBackend as JaxHost  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.block.decode_cuda import decode_blocks  # noqa: E402
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


@pytest.fixture
def backends(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    monkeypatch.setenv("LZ4_TPU_WAVE_DECODE", "0")
    return TpuBackend(), TorchBackend(device="cpu")


def _hc_blocks():
    return [gen_text(6000, seed=1), gen_buffer(4096, 0.7, seed=2),
            b"\x00" * 5000, gen_text(700, seed=3)]


@pytest.mark.parametrize("level", [3, 9])
def test_hc_route_matches_tpu_backend(backends, level):
    tpu, port = backends
    blocks = _hc_blocks()
    ours = port.compress_batch(blocks, level=level)
    assert port.hc_encoded == 1
    assert ours == tpu.compress_batch(blocks, level=level)
    assert ours == [blockcodec.compress_hc(b, level) for b in blocks]
    assert port.decompress_batch(ours, [len(b) for b in blocks]) == blocks


@pytest.mark.parametrize("case", ["level2", "level10", "level12", "dict",
                                  "over64k", "favor", "under4k"])
def test_hc_host_routes(backends, case):
    tpu, port = backends
    blocks = _hc_blocks()
    kw = {"level": 9}
    if case.startswith("level"):
        kw["level"] = int(case[5:])
    elif case == "dict":
        kw["dict_prefixes"] = [gen_text(9000, seed=4)] * len(blocks)
    elif case == "over64k":
        blocks = blocks + [gen_text(70000, seed=5)]
    elif case == "favor":
        kw["favor_dec_speed"] = True
    else:
        blocks = [gen_text(3000, seed=6), gen_buffer(4095, 0.7, seed=7)]
    ours = port.compress_batch(blocks, **kw)
    assert port.hc_encoded == 0
    assert ours == tpu.compress_batch(blocks, **kw)
    if kw["level"] == 2:    # both packages run level 2 on sort/scan graphs
        assert port.device_hc_encoded == 1
    else:
        assert port.device_hc_encoded == 0
        assert ours == HostBackend().compress_batch(blocks, **kw)
        assert ours == JaxHost().compress_batch(blocks, **kw)
    mx = [len(b) for b in blocks]
    prefixes = kw.get("dict_prefixes")
    assert port.decompress_batch(ours, mx, dict_prefixes=prefixes) == blocks


@pytest.fixture(scope="module")
def tpu_level2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LZ4_TPU_PALLAS_CPU", "1")
        yield TpuBackend()


@pytest.mark.parametrize("case", ["nodict", "dict", "over64k", "favor",
                                  "under4k"])
def test_level2_route_matches_tpu_backend(tpu_level2, case):
    """Level 2 on the sort/scan encoder: no-dict and dict batches, a
    block over 64 KB (linked segments, then the seam merge) and
    favor_dec_speed (ignored at level 2) give TpuBackend's bytes; a batch
    of blocks under min_device_size goes to the host in both."""
    port = TorchBackend("cpu")
    blocks = [gen_text(20000, seed=11), gen_buffer(9000, 0.7, seed=12),
              b"\x00" * 5000, gen_text(700, seed=13)]
    kw = {"level": 2}
    if case == "dict":
        kw["dict_prefixes"] = [gen_text(70000, seed=14), None,
                               gen_text(3000, seed=15), b"x" * 10]
    elif case == "over64k":
        blocks = [gen_text(150000, seed=16), gen_buffer(70000, 0.8,
                                                        seed=17)]
    elif case == "favor":
        kw["favor_dec_speed"] = True
    elif case == "under4k":
        blocks = [gen_text(3000, seed=18), gen_buffer(4000, 0.7, seed=19)]
    ours = port.compress_batch(blocks, **kw)
    assert ours == tpu_level2.compress_batch(blocks, **kw)
    assert port.device_hc_encoded == (case != "under4k")
    assert port.hc_encoded == 0
    if case == "under4k":
        assert ours == HostBackend().compress_batch(blocks, **kw)
    else:
        assert ours != HostBackend().compress_batch(blocks, **kw)
    prefixes = kw.get("dict_prefixes")
    assert port.decompress_batch(ours, [len(b) for b in blocks],
                                 dict_prefixes=prefixes) == blocks


def test_small_block_fast_tier_matches_tpu_backend(backends):
    """A batch whose largest block is under min_device_size (4096) goes
    to the host tier in both packages, so their bytes agree."""
    tpu, port = backends
    blocks = [gen_text(2000, seed=1), gen_buffer(3000, 0.7, seed=2),
              gen_text(4000, seed=5)]
    ours = port.compress_batch(blocks)
    assert ours == tpu.compress_batch(blocks)
    assert ours == HostBackend().compress_batch(blocks)
    assert port.decompress_batch(ours, [4000] * 3) == blocks
    # one block at a time (a frame's last, partial block) the host tier
    # runs its per-block codec, whose bytes differ from B1's: the gate
    # is what keeps the packages equal
    b1 = TorchBackend("cpu", min_device_size=0)
    for b in blocks:
        one = port.compress_batch([b])
        assert one == tpu.compress_batch([b])
        assert one != b1.compress_batch([b])


def test_max_device_size_gate(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    block = gen_text(70000, seed=9)
    port = TorchBackend("cpu", max_device_size=65536)
    ours = port.compress_batch([block])
    assert ours == TpuBackend(max_device_size=65536).compress_batch([block])
    assert ours == HostBackend().compress_batch([block])


def test_hc_route_is_one_launch_over_the_batch():
    # the route's arrays are the contract's: one B5 call, cap_n 65536
    blocks = [gen_text(5000, seed=s) for s in range(5)]
    port = TorchBackend("cpu")
    ours = port.compress_batch(blocks, level=5)
    src = np.zeros((5, 65536), np.uint8)
    for i, b in enumerate(blocks):
        src[i, : len(b)] = np.frombuffer(b, np.uint8)
    import torch
    out, cs, _ = encode_blocks_hc(
        torch.from_numpy(src),
        torch.tensor([len(b) for b in blocks], dtype=torch.int32),
        cap_n=65536, level=5)
    assert ours == [out[i, :n].numpy().tobytes()
                    for i, n in enumerate(cs.tolist())]
    dec, olens, errs = decode_blocks(out, cs, cap_out=65536)
    assert not errs.any() and olens.tolist() == [5000] * 5
