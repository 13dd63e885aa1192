"""`TorchBackend.decompress_batch` takes `TpuBackend.decompress_batch`'s
route (LZ4_TPU_PALLAS_CPU=1: its Pallas kernels in interpret mode) for
every gate: the wave tier, the `min_device_size` gate on blocks and
outputs, the `max_device_decode_size` gate, and the > 256 KB tier gate
under `decode_dest`. Spies on each package's host call and device
decodes record the routes, the > 256 KB tiers under "device" taking
each package's piece-wave route (`_decompress_big_batch`, then B2 a
wave). The bytes equal both packages' host tiers; a malformed stream
raises the same error class in every route. Tolerance: exact.
"""
import pytest

jax = pytest.importorskip("jax")

import lz4_tpu.block.backend as jbackend  # noqa: E402
import lz4_tpu.block.decode_pallas as jpallas  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu_torch.block import backend as tbackend  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel import engine as tengine  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _spy(monkeypatch, routes, owner, name, label):
    orig = getattr(owner, name)

    def wrapped(*a, **k):
        routes.append(label)
        return orig(*a, **k)
    monkeypatch.setattr(owner, name, wrapped)


@pytest.fixture
def spied(monkeypatch):
    """(TpuBackend, TorchBackend("cpu"), jax routes, port routes)."""
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    jr, tr = [], []
    _spy(monkeypatch, jr, jbackend.HostBackend, "decompress_batch", "host")
    _spy(monkeypatch, jr, TpuBackend, "decompress_batch_wave", "wave")
    _spy(monkeypatch, jr, jpallas, "decode_blocks_pallas", "B2")
    _spy(monkeypatch, jr, TpuBackend, "_decompress_big_batch", "pieces")
    _spy(monkeypatch, tr, tbackend.HostBackend, "decompress_batch", "host")
    _spy(monkeypatch, tr, TorchBackend, "decompress_batch_wave", "wave")
    _spy(monkeypatch, tr, tengine, "decode_blocks", "B2")
    _spy(monkeypatch, tr, TorchBackend, "_decompress_big_batch", "pieces")
    return TpuBackend(), TorchBackend("cpu"), jr, tr


def _case(name):
    """(blocks, max_outs, dict_prefixes, decode_dest) of one gate."""
    hist = gen_text(70000, seed=3)
    if name == "dict_under_4k":
        blocks = [gen_text(3000, seed=1), hist[-2000:] + b"new" * 300]
        return blocks, [4000, 4000], [hist, hist[-5000:]], "auto"
    if name == "dict_b2":
        blocks = [gen_text(20000, seed=4), hist[-9000:] + b"q" * 9000]
        return blocks, [65536, 65536], [hist, hist[-30000:]], "auto"
    if name in ("over256k_auto", "over256k_device"):
        blocks = [gen_text(300000, seed=5), gen_buffer(280000, 0.8, seed=6)]
        return (blocks, [300 * 1024] * 2, None,
                "device" if name.endswith("device") else "auto")
    if name == "over_decode_cap":
        blocks = [gen_text(90000, seed=7), gen_buffer(70000, 0.7, seed=8)]
        return blocks, [5 << 20, 5 << 20], None, "device"
    raise KeyError(name)


WANT = {"dict_under_4k": "host", "dict_b2": "B2", "over256k_auto": "host",
        "over256k_device": "pieces", "over_decode_cap": "host"}


@pytest.mark.parametrize("name", list(WANT))
def test_decode_route_matches_tpu_backend(spied, name):
    tpu, port, jr, tr = spied
    blocks, max_outs, prefixes, dest = _case(name)
    comp = [blockcodec.compress(b, dict_prefix=d)
            for b, d in zip(blocks, prefixes or [None] * len(blocks))]
    tpu.decode_dest = port.decode_dest = dest
    want = tpu.decompress_batch(comp, max_outs, dict_prefixes=prefixes)
    ours = port.decompress_batch(comp, max_outs, dict_prefixes=prefixes)
    # the piece route launches B2 once a wave; every other route once
    assert tr[0] == jr[0] == WANT[name]
    assert tr[1:] == ["B2"] * (len(tr) - 1 if name == "over256k_device"
                               else 0)
    assert ours == want == blocks
    assert ours == tbackend.HostBackend().decompress_batch(
        comp, max_outs, dict_prefixes=prefixes)
    assert ours == jbackend.HostBackend().decompress_batch(
        comp, max_outs, dict_prefixes=prefixes)


def test_wave_route_matches_tpu_backend(spied):
    tpu, port, jr, tr = spied
    blocks = [gen_text(20000, seed=9), gen_buffer(9000, 0.7, seed=10)]
    comp = [blockcodec.compress(b) for b in blocks]
    assert port.decompress_batch(comp, [65536] * 2) == \
        tpu.decompress_batch(comp, [65536] * 2) == blocks
    assert tr == jr == ["wave"]
    assert port.wave_decoded == 1


@pytest.mark.parametrize("name", ["wave"] + list(WANT) + ["dict_b2_two_bad"])
def test_malformed_stream_raises_in_every_route(spied, name):
    tpu, port, jr, tr = spied
    route = name.removesuffix("_two_bad")
    if name == "wave":
        blocks, max_outs, prefixes, dest = ([gen_text(20000, seed=11)],
                                            [65536], None, "auto")
    else:
        blocks, max_outs, prefixes, dest = _case(route)
    comp = [blockcodec.compress(b, dict_prefix=d)
            for b, d in zip(blocks, prefixes or [None] * len(blocks))]
    # cut the first stream (both, in "_two_bad") inside its sequences
    bad = 2 if name.endswith("_two_bad") else 1
    comp[:bad] = [c[: len(c) // 2] for c in comp[:bad]]
    tpu.decode_dest = port.decode_dest = dest
    with pytest.raises(ValueError) as theirs:
        tpu.decompress_batch(comp, max_outs, dict_prefixes=prefixes)
    with pytest.raises(ValueError) as ours:
        port.decompress_batch(comp, max_outs, dict_prefixes=prefixes)
    assert type(ours.value).__name__ == type(theirs.value).__name__
    # the route entered is the gate's; a stream the wave splitter
    # rejects then goes to the host, which raises, in both
    assert tr[0] == jr[0] == ("wave" if name == "wave" else WANT[route])
    if name == "wave":
        assert tr == jr == ["wave", "host"]
    if bad == 2:
        # the first malformed block in index order raises
        assert str(ours.value) == "malformed block 0"
