"""B2 (serial block decode): the port's plain PyTorch version against the
JAX package's Pallas kernel in interpret mode.

Both get the same numpy arrays; the port's side goes through
`to_device_batch(..., device="cpu")`. Tolerance: exact. err and olen
must be identical on every stream, malformed ones included, and
out[:olen] where err is 0 (bytes past olen are unspecified).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lz4_tpu import native  # noqa: E402
from lz4_tpu.block.decode_pallas import decode_blocks_pallas  # noqa: E402
from lz4_tpu.block.ref_codec import compress_block  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch  # noqa: E402
from lz4_tpu_torch.block.decode_cuda import (decode_blocks,  # noqa: E402
                                             decode_blocks_plain)
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _both(streams, cap_out, dict_prefixes=None, cap_in=None, loose=False):
    """Decode with both packages; assert parity; return the port's
    (out, olen, err) as numpy."""
    cap_in = cap_in or max(16, max(len(c) for c in streams))
    arrays = pack_blocks(streams, dict_prefixes, cap=cap_in,
                         with_dict=dict_prefixes is not None)
    comp, lens, db, dl = arrays
    jo, jl, je = (np.asarray(x) for x in decode_blocks_pallas(
        jnp.asarray(comp), jnp.asarray(lens),
        None if db is None else jnp.asarray(db),
        None if dl is None else jnp.asarray(dl),
        cap_out=cap_out, interpret=True, loose=loose))
    po, pl, pe = decode_blocks(*to_device_batch(*arrays, device="cpu"),
                               cap_out=cap_out, loose=loose)
    assert po.device.type == "cpu" and tuple(po.shape) == jo.shape
    po, pl, pe = po.numpy(), pl.numpy(), pe.numpy()
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pl, jl)
    for i in range(len(streams)):
        if not pe[i]:
            assert po[i, : pl[i]].tobytes() == jo[i, : jl[i]].tobytes(), i
    return po, pl, pe


def test_roundtrip_corpora():
    rng = np.random.default_rng(5)
    srcs = []
    for n in (13, 64, 300, 1024, 4096):
        srcs += [gen_text(n, seed=n), gen_buffer(n, match_prob=0.6, seed=n),
                 b"\x00" * n, rng.bytes(n)]
    srcs += [b"A", b"ab" * 3000, bytes(range(256)) * 20]
    comp = native.blockcodec.compress_batch(srcs)
    out, olen, err = _both(comp, cap_out=8192)
    for i, s in enumerate(srcs):
        assert not err[i] and olen[i] == len(s)
        assert out[i, : len(s)].tobytes() == s


def test_long_matches_60k():
    # long matches exercise the 255-chains and long periodic copies
    srcs = [b"\xaa" * 60000, (b"0123456789abcdef" * 4096)[:60000]]
    comp = [native.blockcodec.compress_hc(s, 9) for s in srcs]
    out, olen, err = _both(comp, cap_out=65536)
    for i, s in enumerate(srcs):
        assert not err[i] and out[i, : len(s)].tobytes() == s


def _mutations(seed=11, n_each=20):
    rng = np.random.default_rng(seed)
    srcs = [gen_text(2048, seed=3), gen_buffer(2048, match_prob=0.6, seed=4)]
    cases = []
    for c in native.blockcodec.compress_batch(srcs):
        cases.append(bytes(c))
        for _ in range(n_each):
            cc = bytearray(c)
            mode = rng.integers(0, 3)
            if mode == 0:
                cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
            elif mode == 1:
                cc = cc[: rng.integers(1, len(cc))]
            else:
                for _ in range(6):
                    cc[rng.integers(0, len(cc))] = rng.integers(0, 256)
            cases.append(bytes(cc))
    return cases


def test_error_parity_mutations():
    cases = _mutations()
    _, _, err = _both(cases, cap_out=4096)
    assert err[0] == 0 and err.sum() > 0


def test_error_parity_edge_streams():
    cases = [b"", b"\x00", b"\x10", b"\x10A", b"\xf0" + b"\xff" * 40,
             b"\x1f" + b"A" + b"\x01\x00" + b"\xff" * 30,
             b"\x40abcd\x00\x00\x00", b"\x44abcd\x05\x00\x00"]
    _both(cases, cap_out=4096)
    # a stream that writes past a small window
    _both([native.blockcodec.compress_batch([b"q" * 3000])[0]], cap_out=1024)


def test_dict_linked_decode():
    whole = gen_text(16000, seed=77)
    n1 = 7000
    hist, b2 = whole[:n1], whole[n1:]
    comp = compress_block(b2, dict_prefix=hist)
    out, olen, err = _both([comp], cap_out=16384, dict_prefixes=[hist],
                           cap_in=len(comp) + 256)
    assert not err[0] and out[0, : olen[0]].tobytes() == b2
    # without the history the same stream reaches before the block start
    _, _, err = _both([comp], cap_out=16384, cap_in=len(comp) + 256)
    assert err[0] == 1


def test_dict_partial_history_and_mutations():
    hist = gen_text(70000, seed=21)
    blk = hist[-5000:-2000] + gen_text(3000, seed=22)
    comp = compress_block(blk, dict_prefix=hist[-65536:])
    cases = [comp] + [comp[:k] for k in (3, len(comp) // 2, len(comp) - 1)]
    _both(cases, cap_out=8192, dict_prefixes=[hist] * len(cases))
    # a shorter history makes far offsets reach before it
    _both(cases, cap_out=8192, dict_prefixes=[hist[-2500:]] * len(cases))


@pytest.mark.parametrize("loose", [False, True])
def test_loose_pieces(loose):
    # pieces of a split block may end right after a match: literals
    # "abcd" + a match of 8 at offset 4, then an empty last sequence
    piece = b"\x44abcd\x04\x00\x00"
    cases = [piece, b"\x42ab\x02\x00\x10Z", piece + b"\x00"]
    cases += _mutations(seed=12, n_each=6)
    out, olen, err = _both(cases, cap_out=4096, loose=loose)
    assert bool(err[0]) != loose
    if loose:
        assert out[0, : olen[0]].tobytes() == b"abcdabcdabcd"


def test_plain_matches_wrapper():
    comp = native.blockcodec.compress_batch([gen_text(3000, seed=1)])
    arrays = to_device_batch(*pack_blocks(comp, cap=4096), device="cpu")
    a = decode_blocks(*arrays, cap_out=4096)
    b = decode_blocks_plain(*arrays, cap_out=4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
