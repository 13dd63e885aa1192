"""B1 (fast-tier block encode): the port's plain PyTorch version against
the JAX package's Pallas kernel in interpret mode, byte for byte.

Both get the same numpy arrays (built by the port's `pack_blocks`);
the port's side goes through `to_device_batch(..., device="cpu")`. Calls
hold at most 64 blocks, the reference kernel's table-tag horizon.
Tolerance: exact (LZ4 output is deterministic integers); bytes of out
past csizes are unspecified in both contracts and not compared.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lz4_tpu.block.encode_pallas import encode_blocks_pallas  # noqa: E402
from lz4_tpu.block.ref_codec import decompress_block  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch  # noqa: E402
from lz4_tpu_torch.block.encode_cuda import (encode_blocks,  # noqa: E402
                                             encode_blocks_plain)
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _both(srcs, cap_n, dict_prefixes=None, **kw):
    """Encode with both packages; assert byte parity; return the port's
    streams."""
    arrays = pack_blocks(srcs, dict_prefixes, cap=cap_n,
                         with_dict=dict_prefixes is not None)
    src, lens, db, dl = arrays
    jo, jc, jt = (np.asarray(x) for x in encode_blocks_pallas(
        jnp.asarray(src), jnp.asarray(lens),
        None if db is None else jnp.asarray(db),
        None if dl is None else jnp.asarray(dl),
        cap_n=cap_n, interpret=True, **kw))
    po, pc, pt = encode_blocks(*to_device_batch(*arrays, device="cpu"),
                               cap_n=cap_n, **kw)
    assert po.device.type == "cpu"
    assert po.dtype == torch.uint8 and tuple(po.shape) == jo.shape
    po, pc, pt = po.numpy(), pc.numpy(), pt.numpy()
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pt, jt)
    for i in range(len(srcs)):
        assert po[i, : pc[i]].tobytes() == jo[i, : jc[i]].tobytes(), i
    return [po[i, : pc[i]].tobytes() for i in range(len(srcs))]


def _corpora():
    rng = np.random.default_rng(6)
    srcs = []
    for n in (1, 12, 13, 64, 300, 1024, 4096, 8000):
        srcs += [gen_text(n, seed=n), gen_buffer(n, match_prob=0.6, seed=n),
                 b"\x00" * n, rng.bytes(n)]
    srcs += [b"ab" * 4000, bytes(range(256)) * 30, b""]
    return srcs


def test_corpora_no_dict():
    srcs = _corpora()
    comp = _both(srcs, cap_n=8192)
    for c, s in zip(comp, srcs):
        assert decompress_block(c, len(s)) == s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dict_linked(seed):
    whole = gen_text(12000, seed=seed)
    n1 = 5000
    comp = _both([whole[n1:]], cap_n=16384, dict_prefixes=[whole[:n1]])
    assert decompress_block(comp[0], len(whole) - n1,
                            dict_prefix=whole[:n1]) == whole[n1:]


def test_dict_full_partial_and_empty_history():
    rng = np.random.default_rng(3)
    hist = gen_text(70000, seed=11)
    srcs = [gen_text(6000, seed=12), gen_buffer(5000, 0.6, seed=13),
            hist[-3000:] + rng.bytes(200), b"xyz", b""]
    prefixes = [hist, hist[-1000:], hist[-4000:], hist, None]
    comp = _both(srcs, cap_n=8192, dict_prefixes=prefixes)
    for c, s, d in zip(comp, srcs, prefixes):
        assert decompress_block(c, len(s), dict_prefix=d) == s


@pytest.mark.parametrize("acceleration", [1, 8])
def test_acceleration_60k_text(acceleration):
    src = gen_text(60000, seed=42)
    comp = _both([src], cap_n=65536, acceleration=acceleration)
    assert decompress_block(comp[0], len(src)) == src


def test_acceleration_max_clamps():
    srcs = [gen_text(8000, seed=5), b"\x07" * 5000]
    comp = _both(srcs, cap_n=8192, acceleration=10 ** 6)
    for c, s in zip(comp, srcs):
        assert decompress_block(c, len(s)) == s


def test_max_dist_2000():
    srcs = [gen_text(30000, seed=71), b"z" * 20000 + gen_text(10000, seed=72)]
    comp = _both(srcs, cap_n=30000, max_dist=2000)
    for c, s in zip(comp, srcs):
        assert decompress_block(c, len(s)) == s


def test_plain_matches_wrapper_and_validates():
    srcs = [gen_text(3000, seed=9), b""]
    arrays = to_device_batch(*pack_blocks(srcs, cap=4096), device="cpu")
    a = encode_blocks(*arrays, cap_n=4096)
    b = encode_blocks_plain(*arrays, cap_n=4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        encode_blocks(*arrays, cap_n=2048)        # src is not [B, cap_n]
    with pytest.raises(ValueError):
        encode_blocks(*arrays, cap_n=4096, max_dist=70000)
    with pytest.raises(TypeError):
        encode_blocks(arrays[0].to(torch.int32), arrays[1], cap_n=4096)
