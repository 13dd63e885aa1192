"""B3's design on the CPU: `decode_wave.WaveParallelModel` runs the order
of `csrc/decode_wave.cu`: phase A with the warps taking the pieces in
turn under a seeded random schedule, every piece parsed from its own
arena slot, writing its literals and every output byte's source; phase
B, pointer jumping in place in a random order until a round changes
nothing. It asserts that every write lies inside the stream's output
bytes, that every source is a lower position and, on valid arenas, that
every byte read at the end is a terminal that phase A wrote.

Its output is held to the plain version (`wave_decode_plain`) and to the
JAX package's `_wave_kernel` in interpret mode (`wave_decode_batch`,
`wave_decode_linked`) on the splitter's arenas: NP 4, 16 and 64,
one-piece streams, far offsets, linked streams with a 64 KB history, and
garbage arenas (the other rows of the batch stay exact). Tolerance:
exact, out[b, :out_lens[b]] (bytes past it are unspecified).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lz4_tpu.block import decode_wave as jdw  # noqa: E402
from lz4_tpu_torch.block import decode_wave as tdw  # noqa: E402
from lz4_tpu_torch.native import blockcodec as bc  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _far(n, seed):
    """Data whose matches sit several KB back."""
    rng = np.random.default_rng(seed)
    chunk = rng.bytes(3000)
    out = b""
    while len(out) < n:
        out += chunk + rng.bytes(2500) + gen_text(2000, seed=len(out))
    return out[:n]


def _rows(out, lens):
    return [out[i, :k].numpy().tobytes() for i, k in enumerate(lens)]


def _three(streams, NP, warps=16, seed=0):
    """Split once; decode with the JAX kernel, the plain version and the
    model; assert parity; return the decoded rows."""
    arenas, out_lens = bc.wave_split_batch(streams, max_pieces=NP)
    want = jdw.wave_decode_batch(arenas, list(out_lens), interpret=True)
    a, n = torch.from_numpy(arenas), torch.from_numpy(out_lens)
    lens = out_lens.tolist()
    assert _rows(tdw.wave_decode_plain(a, n), lens) == want
    out, rounds = tdw.wave_decode_model(a, n, warps=warps, seed=seed)
    assert _rows(out, lens) == want
    assert all(r >= 1 for r in rounds)
    return want


@pytest.mark.parametrize("warps", [1, 3, 8])
def test_mixed_and_hc_streams_np4(warps):
    rng = np.random.default_rng(1)
    srcs = [gen_text(4096, seed=1), gen_buffer(3000, 0.7, seed=2),
            b"\x00" * 4096, rng.bytes(2000), b"Q", b"ab" * 2048]
    streams = [bc.compress(s) for s in srcs] + \
        [bc.compress_hc(s, 9) for s in srcs]
    assert _three(streams, 4, warps=warps, seed=warps) == srcs * 2


def test_far_offsets_np16():
    srcs = [_far(16384, seed=s) for s in range(2)] + [
        gen_text(16384, seed=7), (b"0123456789abcdef" * 1024)]
    streams = [bc.compress(s) for s in srcs] + \
        [bc.compress_hc(s, 12) for s in srcs[:2]]
    assert _three(streams, 16) == srcs + srcs[:2]


@pytest.mark.parametrize("seed", [0, 1])
def test_np64(seed):
    srcs = [gen_text(65536, seed=seed), b"\xaa" * 60000,
            _far(50000, seed=seed + 5)]
    streams = [bc.compress(s) for s in srcs] + [bc.compress_hc(srcs[0], 9)]
    assert _three(streams, 64, seed=seed) == srcs + srcs[:1]


def test_one_piece_streams():
    srcs = [gen_text(k, seed=k) for k in (1, 13, 100, 700, 1024)]
    streams = [bc.compress(s) for s in srcs]
    assert _three(streams, 4) == srcs


def test_linked_with_history(monkeypatch):
    """Round t decodes with round t-1's output as its 64 KB history."""
    whole = [gen_text(65536 + 30000, seed=5),
             _far(65536, seed=6) + _far(65536, seed=6)[:20000]]
    streams = []
    for w in whole:
        b0, b1 = w[:65536], w[65536:]
        streams.append([bc.compress(b0), bc.compress(b1, dict_prefix=b0)])
    want = jdw.wave_decode_linked(streams, interpret=True)
    assert want == whole
    monkeypatch.setattr(tdw, "wave_decode", lambda a, n, h=None:
                        tdw.wave_decode_model(a, n, h)[0])
    assert tdw.wave_decode_linked(streams, device="cpu") == want


def test_garbage_arenas_stay_in_their_rows():
    rng = np.random.default_rng(7)
    srcs = [gen_text(16384, seed=s) for s in range(4)]
    arenas, out_lens = bc.wave_split_batch([bc.compress(s) for s in srcs],
                                           max_pieces=16)
    bad = arenas.copy()
    for i in (0, 2):
        for _ in range(60):
            bad[i, rng.integers(0, 16), rng.integers(0, 1088)] = \
                rng.integers(0, 256)
    hist = torch.from_numpy(rng.integers(0, 256, (4, 65536), dtype=np.uint8))
    a, n = torch.from_numpy(bad), torch.from_numpy(out_lens)
    plain = tdw.wave_decode_plain(a, n, hist)
    # the model asserts every write lies inside the stream's bytes
    out, _ = tdw.wave_decode_model(a, n, hist, strict=False)
    for i in (1, 3):
        k = int(out_lens[i])
        assert torch.equal(out[i, :k], plain[i, :k])
        assert out[i, :k].numpy().tobytes() == srcs[i]


def test_model_catches_an_unresolved_byte():
    """The model's terminal check is live: cut to one round of pointer
    jumping, a stream with chains of copies leaves bytes unresolved."""
    src = _far(16384, seed=3)
    arenas, out_lens = bc.wave_split_batch([bc.compress(src)], max_pieces=16)
    m = tdw.WaveParallelModel(8, seed=0, max_rounds=1)
    with pytest.raises(AssertionError, match="not a written terminal"):
        m.decode(arenas[0].tobytes(), int(out_lens[0]), None, 16)
    full = tdw.WaveParallelModel(8, seed=0)
    assert bytes(full.decode(arenas[0].tobytes(), int(out_lens[0]), None,
                             16)[: len(src)]) == src
    assert full.rounds > 1
