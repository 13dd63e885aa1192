"""Kernels B1 and B2 against their plain PyTorch versions on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. On a machine with
the card (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (LZ4 output is deterministic integers).
"""
import numpy as np
import pytest
import torch

from lz4_tpu_torch.block import decode_cuda, encode_cuda
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _random_blocks(rng, count, max_len):
    out = []
    for _ in range(count):
        n = int(rng.integers(0, max_len + 1))
        kind = rng.integers(0, 4)
        if kind == 0:
            out.append(gen_text(n, seed=int(rng.integers(1 << 30))))
        elif kind == 1:
            out.append(gen_buffer(n, float(rng.random()),
                                  seed=int(rng.integers(1 << 30))))
        elif kind == 2:
            out.append(rng.bytes(n))
        else:
            out.append(bytes(rng.integers(0, 3, n, dtype=np.uint8)))
    return out


def _encode_both(cuda, blocks, prefixes=None, cap=65536, **kw):
    arrays = pack_blocks(blocks, prefixes, cap=cap,
                         with_dict=prefixes is not None)
    gpu = encode_cuda.encode_blocks(*to_device_batch(*arrays, device=cuda),
                                    cap_n=cap, **kw)
    plain = encode_cuda.encode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_n=cap, **kw)
    go, gc, gt = (x.cpu() for x in gpu)
    po, pc, pt = plain
    assert torch.equal(gc, pc) and torch.equal(gt, pt)
    for i, n in enumerate(pc.tolist()):
        assert torch.equal(go[i, :n], po[i, :n]), i
    return [po[i, :n].numpy().tobytes() for i, n in enumerate(pc.tolist())]


def _decode_both(cuda, streams, prefixes=None, cap_out=65536, loose=False):
    arrays = pack_blocks(streams, prefixes,
                         cap=max(16, max(len(s) for s in streams)),
                         with_dict=prefixes is not None)
    gpu = decode_cuda.decode_blocks(*to_device_batch(*arrays, device=cuda),
                                    cap_out=cap_out, loose=loose)
    go, gl, ge = (x.cpu() for x in gpu)
    po, pl, pe = decode_cuda.decode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_out=cap_out,
        loose=loose)
    assert torch.equal(ge, pe) and torch.equal(gl, pl)
    for i, n in enumerate(pl.tolist()):
        if not pe[i]:
            assert torch.equal(go[i, :n], po[i, :n]), i
    return pe


@pytest.mark.parametrize("seed", range(4))
def test_b1_random_batches(cuda, seed):
    rng = np.random.default_rng(seed)
    blocks = _random_blocks(rng, 24, 65536)
    accel = int(rng.choice([1, 2, 8, 65537]))
    _encode_both(cuda, blocks, acceleration=accel)
    _encode_both(cuda, blocks, max_dist=int(rng.integers(1, 65536)))
    hist = gen_text(70000, seed=seed)
    prefixes = [hist[-int(rng.integers(0, 70000)):] or None for _ in blocks]
    _encode_both(cuda, blocks, prefixes, acceleration=accel)


@pytest.mark.parametrize("seed", range(4))
def test_b2_random_and_mutated(cuda, seed):
    rng = np.random.default_rng(100 + seed)
    blocks = _random_blocks(rng, 16, 65536)
    streams = _encode_both(cuda, blocks)
    assert not _decode_both(cuda, streams).any()
    bad = []
    for k in range(200):
        cc = bytearray(streams[k % len(streams)])
        if len(cc) > 1 and rng.random() < 0.5:
            cc = cc[: int(rng.integers(1, len(cc)))]
        for _ in range(int(rng.integers(1, 6))):
            cc[int(rng.integers(0, len(cc)))] = int(rng.integers(0, 256))
        bad.append(bytes(cc))
    _decode_both(cuda, bad)
    _decode_both(cuda, bad, loose=True)
    _decode_both(cuda, bad, cap_out=4096)
    hist = gen_text(70000, seed=seed)
    _decode_both(cuda, bad, [hist[-int(rng.integers(0, 70000)):] or None
                             for _ in bad])


def test_backend_on_card_matches_plain(cuda):
    data = gen_text(300000, seed=5) + gen_buffer(200000, 0.7, seed=6)
    blocks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    gpu, cpu = TorchBackend(cuda), TorchBackend("cpu")
    ours = gpu.compress_batch(blocks)
    assert ours == cpu.compress_batch(blocks)
    assert gpu.decompress_batch(ours, [65536] * len(blocks)) == blocks
    big = gpu.compress_batch([data], dict_prefixes=[blocks[0]])
    assert big == cpu.compress_batch([data], dict_prefixes=[blocks[0]])
    assert gpu.decompress_batch(big, [1 << 20],
                                dict_prefixes=[blocks[0]]) == [data]


def test_wrappers_raise_on_wrong_layout(cuda):
    src = torch.zeros((4, 128), dtype=torch.uint8, device=cuda)
    lens = torch.full((4,), 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        encode_cuda.encode_blocks(src.t().contiguous().t(), lens, cap_n=128)
    with pytest.raises(ValueError, match="is on"):
        encode_cuda.encode_blocks(src, lens.cpu(), cap_n=128)
    with pytest.raises(TypeError):
        decode_cuda.decode_blocks(src, lens.to(torch.int64), cap_out=128)
