"""Big-block device decode: the `split_stream` facade against
`lz4_tpu.native`'s on the corpora of `tests/test_bigdecode.py`, and the
piece-wave route (`TorchBackend._decompress_big_batch` on
`device="cpu"`, B2's plain version a wave) against
`TpuBackend._decompress_big_batch` with its Pallas kernel in interpret
mode (LZ4_TPU_PALLAS_CPU=1): plain, dict-prefixed and seam-crossing
blocks, and malformed streams. Tolerance: exact (bytes, piece tables,
error classes)."""
import numpy as np
import pytest

pytest.importorskip("jax")

from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
from lz4_tpu_torch.block.backend import BlockDecodeError  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel import engine as tengine  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _corpus(name):
    rng = np.random.default_rng(7)
    return {
        "text": lambda: gen_text(300_000, seed=1),
        "buffer": lambda: gen_buffer(220_000, match_prob=0.7, seed=2),
        "rle": lambda: b"\x00" * 200_000,
        "periodic": lambda: b"0123456789abcdef" * 20_000,
        "random": lambda: rng.bytes(150_000),
        "one_piece": lambda: gen_text(65536, seed=3),
        "two_pieces": lambda: gen_text(65537, seed=4),
        "mixed": lambda: b"A" * 70_000 + rng.bytes(70_000) + b"B" * 70_000,
    }[name]()


SPLIT_CASES = ["text", "buffer", "rle", "periodic", "random", "one_piece",
               "two_pieces", "mixed", "hc9", "out_limit_16k"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_stream_matches_reference(case):
    if case == "hc9":
        comp = blockcodec.compress_hc(gen_text(400_000, seed=9), level=9)
        kw = {}
    elif case == "out_limit_16k":
        comp = blockcodec.compress(gen_text(100_000, seed=5))
        kw = {"out_limit": 16384, "out_cap": 100_000}
    else:
        comp = blockcodec.compress(_corpus(case))
        kw = {}
    ours = blockcodec.split_stream(comp, **kw)
    ref = jnative.blockcodec.split_stream(comp, **kw)
    assert ours is not None and ref is not None
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("comp,kw", [
    (bytes([0x11, 0x41, 0x00, 0x00]) + b"A" * 40, {}),   # offset 0
    (bytes([0xF0, 0x41]), {}),                           # literal overrun
    (b"", {}),                                           # empty
    ("cap", {"out_cap": 99_990}),                        # end rules
])
def test_split_stream_rejects_as_reference(comp, kw):
    if comp == "cap":
        comp = blockcodec.compress(gen_text(100_000, seed=5))
    assert blockcodec.split_stream(comp, **kw) is None
    assert jnative.blockcodec.split_stream(comp, **kw) is None


def _piece_case(name):
    """(blocks, max_outs, dict_prefixes) of one piece-route case."""
    hist = gen_text(70_000, seed=11)
    if name == "plain":
        blocks = [gen_text(150_000, seed=12), gen_buffer(90_000, 0.6,
                                                          seed=13)]
        return blocks, [len(b) for b in blocks], None
    if name == "seams":
        # dense long matches: copies reach back across every piece seam
        blocks = [gen_buffer(200_000, 0.97, seed=14),
                  (gen_text(3000, seed=15) * 70)[:180_000]]
        return blocks, [len(b) + 17 for b in blocks], None
    if name == "dict":
        blocks = [hist[5000:60000] + gen_text(80_000, seed=16),
                  hist[-300:] * 400]
        return blocks, [len(b) for b in blocks], [hist, hist[-300:]]
    if name == "short_dict":
        blocks = [b"history!" * 20_000, gen_text(70_000, seed=17)]
        return blocks, [len(b) for b in blocks], [b"history!", None]
    raise KeyError(name)


@pytest.fixture
def pallas_cpu(monkeypatch):
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")


@pytest.mark.parametrize("name", ["plain", "seams", "dict", "short_dict"])
def test_piece_route_matches_tpu_backend(pallas_cpu, monkeypatch, name):
    blocks, max_outs, prefixes = _piece_case(name)
    comp = [blockcodec.compress(b, dict_prefix=d)
            for b, d in zip(blocks, prefixes or [None] * len(blocks))]
    launches = []
    orig = tengine.decode_blocks

    def spy(*a, **k):
        launches.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(tengine, "decode_blocks", spy)
    be = TorchBackend("cpu")
    ours = be._decompress_big_batch(comp, max_outs, prefixes)
    want = TpuBackend()._decompress_big_batch(comp, max_outs, prefixes)
    assert ours == want == blocks
    # one B2 launch a wave, each loose with a 64 KB output
    waves = max(len(blockcodec.split_stream(c, out_cap=m)[1])
                for c, m in zip(comp, max_outs))
    assert len(launches) == waves > 1
    assert all(k == {"cap_out": 65536, "loose": True} for k in launches)
    assert be.piece_decoded == 1 and be.host_fallbacks == 0


@pytest.mark.parametrize("how", ["cut", "flip", "over_cap"])
def test_piece_route_malformed_raises(pallas_cpu, how):
    src = [gen_text(150_000, seed=18), gen_buffer(120_000, 0.8, seed=19)]
    comp = [blockcodec.compress(b) for b in src]
    max_outs = [len(b) for b in src]
    if how == "cut":
        comp[1] = comp[1][: len(comp[1]) // 2]
    elif how == "flip":
        bad = bytearray(comp[0])
        bad[100] ^= 0xFF
        comp[0] = bytes(bad)
    else:
        max_outs[0] -= 1
    be = TorchBackend("cpu")
    with pytest.raises(ValueError) as theirs:
        TpuBackend()._decompress_big_batch(comp, max_outs, None)
    with pytest.raises(BlockDecodeError) as ours:
        be._decompress_big_batch(comp, max_outs, None)
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_decode_dest_device_takes_the_piece_route():
    """Outputs over 256 KB with decode_dest "device" decode as pieces;
    "auto" sends them to the host tier, as in TpuBackend."""
    blocks = [gen_text(400_000, seed=20), gen_buffer(300_000, 0.9, seed=21)]
    comp = blockcodec.compress_batch(blocks)
    be = TorchBackend("cpu")
    assert be.decompress_batch(comp, [1 << 20] * 2) == blocks
    assert be.piece_decoded == 0
    be.decode_dest = "device"
    assert be.decompress_batch(comp, [1 << 20] * 2) == blocks
    assert be.piece_decoded == 1
    be.serial_decode = False
    assert be.decompress_batch(comp, [1 << 20] * 2) == blocks
    assert be.piece_decoded == 1


def test_decode_pieces_carries_history_per_row():
    """`_decode_pieces` directly: the next wave's history is the last
    64 KB of history ++ output, row by row, and an empty slot keeps its
    row's history."""
    import torch
    rng = np.random.default_rng(22)
    srcs = [gen_buffer(100_000, 0.95, seed=23), rng.bytes(40_000)]
    splits = [blockcodec.split_stream(blockcodec.compress(s)) for s in srcs]
    comp, plens = tengine.pack_pieces(splits)
    waves = plens.shape[0]
    hist = torch.zeros((2, 65536), dtype=torch.uint8)
    hist[1, -5:] = torch.tensor(list(b"12345"), dtype=torch.uint8)
    hlen = torch.tensor([0, 5], dtype=torch.int32)
    outs, olens, errs = tengine._decode_pieces(
        torch.from_numpy(comp.reshape(-1, tengine.PIECE_CAP)),
        torch.from_numpy(plens.reshape(-1)), hist, hlen, waves=waves)
    assert not errs.any()
    for i, (_, pl, po) in enumerate(splits):
        assert olens[: len(pl), i].tolist() == list(po)
        assert olens[len(pl):, i].tolist() == [0] * (waves - len(pl))
        got = b"".join(outs[k, i, : olens[k, i]].numpy().tobytes()
                       for k in range(len(pl)))
        assert got == srcs[i]
