"""Kernels B1-B6 and the probe kernels P1-P4 against their plain PyTorch
versions on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. On a machine with
the card (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (LZ4 output is deterministic integers).
"""
import numpy as np
import pytest
import torch

from lz4_tpu_torch import xxh32_device
from lz4_tpu_torch.block import decode_cuda, decode_wave, encode_cuda
from lz4_tpu_torch.block import encode_hc, encode_wave
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch
from lz4_tpu_torch.native import blockcodec, xxh
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.probes import (fullbench, gather_probe, lane_probe,
                                  torture, walk_probe)
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_hash_walk,
                                         gen_slot_words, gen_text)
from lz4_tpu_torch.xxh32 import xxh32_batch

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
    return [go[i, :n].numpy().tobytes() for i, n in enumerate(gc.tolist())]


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


@pytest.mark.parametrize("accel", [1, 4, 8, 65537])
def test_b1_hash_collision_blocks(cuda, accel):
    """Probes of one lockstep scan window sharing table slots."""
    blocks = [gen_hash_walk(16384, seed=accel), gen_slot_words(16384,
                                                               seed=accel),
              gen_slot_words(3000, pool=4, seed=accel + 1), b"", b"q" * 13]
    _encode_both(cuda, blocks, cap=16384, acceleration=accel)
    hist = gen_hash_walk(70000, seed=accel + 2)
    _encode_both(cuda, blocks, [hist, hist[-5000:], None, hist, hist[-1:]],
                 cap=16384, acceleration=accel)


def test_b1_dict_partial_history_max_acceleration(cuda):
    hist = gen_text(70000, seed=31)
    blocks = [hist[-9000:-1000] + b"tail" * 500, gen_text(30000, seed=32),
              gen_buffer(20000, 0.8, seed=33), b"abc", b""]
    prefixes = [hist[-12000:], hist[-300:], hist, None, hist[-64:]]
    for accel in (1, 65537):
        _encode_both(cuda, blocks, prefixes, acceleration=accel)
    _encode_both(cuda, blocks, prefixes, dict_stride=1, max_dist=3000)


def test_b1_rows_of_odd_width(cuda):
    """cap_n not a multiple of 4: the kernel reads the rows byte by byte."""
    rng = np.random.default_rng(78)
    blocks = _random_blocks(rng, 12, 5003) + [b"", b"x" * 5003]
    _encode_both(cuda, blocks, cap=5003)
    hist = gen_text(70000, seed=79)
    _encode_both(cuda, blocks, [hist[-k:] or None for k in
                                rng.integers(0, 70000, len(blocks))],
                 cap=5003, acceleration=3)


def test_b1_more_than_64_blocks(cuda):
    """One call of 100 blocks: a block's bytes do not depend on its place
    in the batch."""
    rng = np.random.default_rng(77)
    blocks = _random_blocks(rng, 100, 8192)
    fwd = _encode_both(cuda, blocks, cap=8192)
    rev = _encode_both(cuda, blocks[::-1], cap=8192)
    assert rev[::-1] == fwd


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


def _wave_both(cuda, arenas, out_lens, hist=None, rows=None):
    a, n = torch.from_numpy(arenas), torch.from_numpy(out_lens)
    h = None if hist is None else torch.from_numpy(hist)
    gpu = decode_wave.wave_decode(a.to(cuda), n.to(cuda),
                                  None if h is None else h.to(cuda)).cpu()
    plain = decode_wave.wave_decode_plain(a, n, h)
    for i in (range(len(out_lens)) if rows is None else rows):
        k = int(out_lens[i])
        assert torch.equal(gpu[i, :k], plain[i, :k]), i
    return gpu


@pytest.mark.parametrize("seed", range(3))
def test_b3_random_and_mutated_arenas(cuda, seed):
    rng = np.random.default_rng(200 + seed)
    blocks = _random_blocks(rng, 24, 65536)
    streams = [blockcodec.compress(b) if i % 3 else
               blockcodec.compress_hc(b, 9) for i, b in enumerate(blocks)]
    arenas, out_lens = blockcodec.wave_split_batch(streams, max_pieces=64)
    gpu = _wave_both(cuda, arenas, out_lens)
    for i, b in enumerate(blocks):
        assert gpu[i, : len(b)].numpy().tobytes() == b
    # garbage in half the arenas stays inside its own rows
    bad = arenas.copy()
    for i in range(0, len(bad), 2):
        for _ in range(50):
            bad[i, rng.integers(0, 64), rng.integers(0, 1088)] = \
                rng.integers(0, 256)
    hist = rng.integers(0, 256, (len(bad), 65536), dtype=np.uint8)
    _wave_both(cuda, bad, out_lens, hist, rows=range(1, len(bad), 2))
    torch.cuda.synchronize()


def test_b3_linked_matches_plain(cuda):
    data = [gen_text(200000, seed=s) for s in range(3)] + [
        gen_buffer(150000, 0.8, seed=9)]
    streams = []
    for d in data:
        blocks = [d[i: i + 65536] for i in range(0, len(d), 65536)]
        streams.append([blockcodec.compress(
            b, dict_prefix=d[max(0, k * 65536 - 65536): k * 65536] or None)
            for k, b in enumerate(blocks)])
    gpu = decode_wave.wave_decode_linked(streams, device=cuda)
    assert gpu == decode_wave.wave_decode_linked(streams, device="cpu")
    assert gpu == data


@pytest.mark.parametrize("seed", range(3))
def test_b4_random_and_mutated(cuda, seed):
    rng = np.random.default_rng(300 + seed)
    blocks = _random_blocks(rng, 12, 65536)
    blocks += [bytes(c ^ int(rng.integers(0, 2)) for c in b[:5000])
               for b in blocks[:4]]
    n_rows = encode_wave.rows_for(max(len(b) for b in blocks))
    inp, lens = (torch.from_numpy(a)
                 for a in encode_wave.pack_input(blocks, n_rows))
    hb = int(rng.integers(9, 13))
    md = int(rng.choice([1024, 2048, 65535, int(rng.integers(1, 65535))]))
    gpu = encode_wave.find_matches(inp.to(cuda), lens.to(cuda),
                                   max_dist=md, hash_bits=hb).cpu()
    plain = encode_wave.find_matches_plain(inp, lens, max_dist=md,
                                           hash_bits=hb)
    assert torch.equal(gpu, plain), (hb, md)
    wr = encode_wave.history_rows(md, n_rows)
    hist = torch.from_numpy(rng.integers(0, 256, (len(blocks), wr * 4),
                                         dtype=np.uint8))
    hlen = torch.from_numpy(rng.integers(0, wr * 4 + 1, len(blocks),
                                         dtype=np.int32))
    hlen[0] = wr * 4
    gpu = encode_wave.find_matches(inp.to(cuda), lens.to(cuda),
                                   hist.to(cuda), hlen.to(cuda),
                                   max_dist=md, hash_bits=hb).cpu()
    plain = encode_wave.find_matches_plain(inp, lens, hist, hlen,
                                           max_dist=md, hash_bits=hb)
    assert torch.equal(gpu, plain), (hb, md, "linked")


def test_b4_linked_streams_match_plain(cuda):
    data = [gen_text(150000, seed=11), gen_buffer(130000, 0.7, seed=12)]
    streams = [[d[i: i + 65536] for i in range(0, len(d), 65536)]
               for d in data]
    for md in (2048, 65535):
        gpu = encode_wave.encode_wave_linked(streams, max_dist=md,
                                             device=cuda)
        assert gpu == encode_wave.encode_wave_linked(streams, max_dist=md,
                                                     device="cpu")


def test_backend_wave_routes_on_card(cuda):
    data = gen_text(300000, seed=7) + gen_buffer(200000, 0.7, seed=8)
    blocks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    gpu, cpu = TorchBackend(cuda), TorchBackend("cpu")
    capped = gpu.compress_batch(blocks, max_dist=2048)
    assert capped == cpu.compress_batch(blocks, max_dist=2048)
    n = decode_wave.launches
    assert gpu.decompress_batch(capped, [65536] * len(blocks)) == blocks
    assert decode_wave.launches == n + 1 and gpu.host_fallbacks == 0


@pytest.mark.parametrize("seed", range(3))
def test_b5_random_and_edge_batches(cuda, seed):
    rng = np.random.default_rng(400 + seed)
    cap = 16384
    blocks = _random_blocks(rng, 10, cap) + [
        b"", b"abcabcabcab", b"\x00" * cap, b"abab" * (cap // 4),
        gen_text(200, seed=seed), gen_buffer(cap, 0.97, seed=seed)]
    src, lens, _, _ = pack_blocks(blocks, cap=cap)
    lens[1] = cap + 100                   # clamped into [0, cap]
    src_t, lens_t = torch.from_numpy(src), torch.from_numpy(lens)
    for level in (3, 5, 9):
        for favor in (False, True):
            kw = dict(cap_n=cap, level=level, favor_dec_speed=favor)
            go, gc, gt = (x.cpu() for x in encode_hc.encode_blocks_hc(
                src_t.to(cuda), lens_t.to(cuda), **kw))
            po, pc, pt = encode_hc.encode_blocks_hc_plain(src_t, lens_t, **kw)
            assert torch.equal(gc, pc) and torch.equal(gt, pt), (level, favor)
            for i, n in enumerate(pc.tolist()):
                assert torch.equal(go[i, :n], po[i, :n]), (level, favor, i)
    torch.cuda.synchronize()


def _hc_both(cuda, src, lens, **kw):
    """B5 on the card against the plain version: identical csizes,
    trailing and out[:csize]; returns the streams."""
    src_t, lens_t = torch.from_numpy(src), torch.from_numpy(lens)
    go, gc, gt = (x.cpu() for x in encode_hc.encode_blocks_hc(
        src_t.to(cuda), lens_t.to(cuda), **kw))
    po, pc, pt = encode_hc.encode_blocks_hc_plain(src_t, lens_t, **kw)
    assert torch.equal(gc, pc) and torch.equal(gt, pt), kw
    for i, n in enumerate(pc.tolist()):
        assert torch.equal(go[i, :n], po[i, :n]), (kw, i)
    return [go[i, :n].numpy().tobytes() for i, n in enumerate(gc.tolist())]


@pytest.mark.parametrize("favor", [False, True])
def test_b5_full_rows_of_zeros_and_patterns(cuda, favor):
    """64 KB rows at level 9: counts that run the whole row, and the
    repeat-pattern analysis on periodic rows."""
    rows = [bytes(65536), b"abab" * 16384, b"abcd" * 16384,
            (b"xyz" * 21846)[:65536],
            b"\x07" * 30000 + b"ab" * 10000 + bytes(15536)]
    src, lens, _, _ = pack_blocks(rows, cap=65536)
    for level in (3, 9):
        out = _hc_both(cuda, src, lens, cap_n=65536, level=level,
                       favor_dec_speed=favor)
        for row, s in zip(rows, out):
            assert blockcodec.decompress(s, len(row)) == row


@pytest.mark.parametrize("cap", [65536, 65533, 4099])
def test_b5_row_widths(cuda, cap):
    """cap_n that is and is not a multiple of 4 or 16 (rows that are not
    16-byte aligned in device memory); full rows and rows whose bytes past
    their length are not zero."""
    rng = np.random.default_rng(cap)
    blocks = _random_blocks(rng, 4, cap) + [gen_text(cap, seed=cap),
                                            gen_buffer(cap, 0.9, seed=1)]
    src, lens, _, _ = pack_blocks(blocks, cap=cap)
    src[:, :] = np.where(np.arange(cap)[None, :] < lens[:, None], src,
                         rng.integers(0, 256, src.shape, dtype=np.uint8))
    lens[-1] = cap - 7
    for level, favor in ((3, False), (9, False), (5, True)):
        _hc_both(cuda, src, lens, cap_n=cap, level=level,
                 favor_dec_speed=favor)


def test_b5_lengths_under_13(cuda):
    """Rows of 0-12 bytes (no search: mflimit < 0) and 13-16, with other
    bytes behind their length; lengths outside [0, cap_n] clamp."""
    rng = np.random.default_rng(13)
    cap = 64
    src = rng.integers(0, 256, (21, cap), dtype=np.uint8)
    src[::3] = np.frombuffer(b"ab" * (cap // 2), np.uint8)
    lens = np.array(list(range(17)) + [-4, cap + 9, cap, 12], np.int32)
    for level in (3, 9):
        for favor in (False, True):
            _hc_both(cuda, src, lens, cap_n=cap, level=level,
                     favor_dec_speed=favor)


def test_b5_more_than_one_wave(cuda):
    """One call of 300 blocks, more than one CTA per SM: a block's bytes
    do not depend on its place in the batch."""
    rng = np.random.default_rng(132)
    blocks = _random_blocks(rng, 300, 4096)
    src, lens, _, _ = pack_blocks(blocks, cap=4096)
    fwd = _hc_both(cuda, src, lens, cap_n=4096, level=9)
    rev = _hc_both(cuda, src[::-1].copy(), lens[::-1].copy(), cap_n=4096,
                   level=9)
    assert rev[::-1] == fwd
    _hc_both(cuda, src, lens, cap_n=4096, level=4, favor_dec_speed=True)


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, 12345])
def test_b6_random_rows(cuda, seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    for cap in (16, 4096, 65536):
        lens = [int(k) for k in rng.integers(0, cap + 1, 40)]
        rows = [rng.bytes(k) for k in lens + [0, min(15, cap), cap]]
        data, lens_a, _, _ = pack_blocks(rows, cap=cap)
        d, n = torch.from_numpy(data), torch.from_numpy(lens_a)
        gpu = xxh32_device.xxh32_blocks(d.to(cuda), n.to(cuda), seed,
                                        cap=cap).cpu()
        plain = xxh32_device.xxh32_blocks_plain(d, n, seed, cap=cap)
        assert torch.equal(gpu, plain), cap
        assert gpu.tolist() == [xxh.xxh32(r, seed) for r in rows]


def _b6_vs_host(cuda, data, lens, seed):
    gpu = xxh32_device.xxh32_blocks(torch.from_numpy(data).to(cuda),
                                    torch.from_numpy(lens).to(cuda), seed,
                                    cap=data.shape[1])
    torch.cuda.synchronize()
    assert gpu.cpu().numpy().astype(np.uint32).tolist() == \
        xxh32_batch(data, lens, seed).tolist()


@pytest.mark.parametrize("cap", [1 << 20, 4 << 20])
def test_b6_long_rows_match_host(cuda, cap):
    """Rows whose chain, not their bytes, sets B6's time; lengths on and
    around a stage (2 KB) and a stripe boundary."""
    rng = np.random.default_rng(cap)
    S = xxh32_device.STAGE_BYTES
    lens = np.array([cap, cap - 1, cap - 16, cap - S + 17, S - 1, S, S + 1,
                     S * 4 + 15], np.int32)
    data = rng.integers(0, 256, (len(lens), cap), dtype=np.uint8)
    _b6_vs_host(cuda, data, lens, 0xDEADBEEF)
    _b6_vs_host(cuda, data[:1], lens[:1], 0)


@pytest.mark.parametrize("B", [1, 7, 8, 9, 768, 1100])
def test_b6_batch_sizes_match_host(cuda, B):
    """B below, at and above a warp's 8 rows and the SM count; ragged
    lengths 0..cap."""
    rng = np.random.default_rng(B)
    cap = 8192
    lens = rng.integers(0, cap + 1, B).astype(np.int32)
    lens[: min(B, 6)] = [0, 15, 16, 17, cap, 2048][: min(B, 6)]
    data = rng.integers(0, 256, (B, cap), dtype=np.uint8)
    for seed in (0, 1, 0xFFFFFFFF):
        _b6_vs_host(cuda, data, lens, seed)


def test_backend_hc_route_on_card(cuda):
    data = gen_text(300000, seed=15) + gen_buffer(200000, 0.7, seed=16)
    blocks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    gpu = TorchBackend(cuda)
    n = encode_hc.launches
    for level in (3, 9):
        ours = gpu.compress_batch(blocks, level=level)
        assert ours == HostBackend().compress_batch(blocks, level=level)
        assert gpu.decompress_batch(ours, [65536] * len(blocks)) == blocks
    assert encode_hc.launches == n + 2 and gpu.hc_encoded == 2


def _b4_case_blocks(seed):
    """The lockstep cases of tests/test_torch_encode_wave_lockstep.py:
    text, a 4-value byte pool, zeros, random bytes, short rows, lengths of
    every residue mod 4, and runs longer than 16 KB."""
    rng = np.random.default_rng(seed)
    return [gen_text(16381, seed=seed),
            bytes(rng.integers(0, 4, 16382, dtype=np.uint8)),
            b"\x00" * 16383, rng.bytes(8193), gen_buffer(16384, 0.8, seed=1),
            b"Q", b"", b"abc" * 4, b"\x00" * 40000, b"abc" * 13334,
            gen_text(3000, seed=3) + b"z" * 37001]


@pytest.mark.parametrize("hash_bits,max_dist",
                         [(9, 2048), (10, 2048), (10, 65534), (15, 65534),
                          (15, 2048)])
def test_b4_lockstep_cases(cuda, hash_bits, max_dist):
    blocks = _b4_case_blocks(hash_bits)
    n_rows = encode_wave.rows_for(max(len(b) for b in blocks))
    inp, lens = (torch.from_numpy(a)
                 for a in encode_wave.pack_input(blocks, n_rows))
    kw = dict(max_dist=max_dist, hash_bits=hash_bits)
    gpu = encode_wave.find_matches(inp.to(cuda), lens.to(cuda), **kw).cpu()
    assert torch.equal(gpu, encode_wave.find_matches_plain(inp, lens, **kw))
    wr = encode_wave.history_rows(max_dist, n_rows)
    rng = np.random.default_rng(hash_bits)
    text = np.frombuffer(gen_text(70000, seed=5), np.uint8)
    hist = np.tile(text[-wr * 4:], (len(blocks), 1))
    hist[1] = rng.integers(0, 4, wr * 4, dtype=np.uint8)
    hlen = rng.integers(0, wr * 4 + 1, len(blocks), dtype=np.int32)
    hlen[:2] = wr * 4
    hist, hlen = torch.from_numpy(hist), torch.from_numpy(hlen)
    gpu = encode_wave.find_matches(inp.to(cuda), lens.to(cuda),
                                   hist.to(cuda), hlen.to(cuda), **kw).cpu()
    assert torch.equal(gpu, encode_wave.find_matches_plain(
        inp, lens, hist, hlen, **kw)), "linked"


def test_backend_level2_on_card(cuda):
    """Level 2 on the sort/scan encoder: the card's bytes equal the CPU's
    (no-dict, dict, a block over 64 KB), with no kernel launch."""
    data = gen_text(300000, seed=17) + gen_buffer(200000, 0.7, seed=18)
    blocks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    gpu, cpu = TorchBackend(cuda), TorchBackend("cpu")
    before = (encode_cuda.launches, encode_hc.launches)
    for kw in ({}, {"dict_prefixes": [data[:70000]] * len(blocks)}):
        ours = gpu.compress_batch(blocks, level=2, **kw)
        assert ours == cpu.compress_batch(blocks, level=2, **kw)
        assert HostBackend().decompress_batch(
            ours, [65536] * len(blocks), **kw) == blocks
    big = gpu.compress_batch([data[:200000], data[200000:]], level=2)
    assert big == cpu.compress_batch([data[:200000], data[200000:]], level=2)
    assert (encode_cuda.launches, encode_hc.launches) == before
    assert gpu.device_hc_encoded == 3


@pytest.mark.parametrize("cap_out", [65536, 70000])
def test_b2_main_and_wide_rows(cuda, cap_out):
    """B2 holds to the plain version on valid, overlapping, mutated, dict
    and loose streams, at the main path's width and wider."""
    rng = np.random.default_rng(300 + cap_out % 7)
    blocks = _random_blocks(rng, 12, 65536) + [
        rng.bytes(off) * (3000 // off) for off in range(1, 32, 3)]
    streams = [blockcodec.compress(b) if i % 2 else
               blockcodec.compress_hc(b, 9) for i, b in enumerate(blocks)]
    assert not _decode_both(cuda, streams, cap_out=cap_out).any()
    bad = []
    for k in range(60):
        cc = bytearray(streams[k % len(streams)])
        if len(cc) > 1 and k % 2:
            cc = cc[: int(rng.integers(1, len(cc)))]
        for _ in range(int(rng.integers(1, 4))):
            cc[int(rng.integers(0, len(cc)))] = int(rng.integers(0, 256))
        bad.append(bytes(cc))
    _decode_both(cuda, bad, cap_out=cap_out)
    _decode_both(cuda, bad, cap_out=cap_out, loose=True)
    hist = gen_text(70000, seed=cap_out)
    _decode_both(cuda, streams[:8] + bad[:8],
                 [hist[-int(rng.integers(0, 70000)):] or None
                  for _ in range(16)], cap_out=cap_out)


def test_b2_many_blocks_and_4mb_rows(cuda):
    """A batch wider than the card's resident CTAs, and 4 MB rows (the
    decode_dest "device" route)."""
    data = gen_text(1 << 20, seed=41) + gen_buffer(1 << 20, 0.8, seed=42)
    blocks = [data[i: i + 8192] for i in range(0, len(data), 8192)]
    streams = blockcodec.compress_batch(blocks)
    arrays = pack_blocks(streams, cap=max(len(s) for s in streams))
    out, olen, err = decode_cuda.decode_blocks(
        *to_device_batch(*arrays, device=cuda), cap_out=8192)
    out = out.cpu()
    assert not err.any()
    assert [out[i, : len(b)].numpy().tobytes() for i, b in
            enumerate(blocks)] == blocks
    big = [data[: 4 << 20], data[1000: 3 << 20]]
    comp = blockcodec.compress_batch(big)
    arrays = pack_blocks(comp, cap=max(len(s) for s in comp))
    out, olen, err = decode_cuda.decode_blocks(
        *to_device_batch(*arrays, device=cuda), cap_out=4 << 20)
    out = out.cpu()
    assert not err.any()
    assert [out[i, : len(b)].numpy().tobytes() for i, b in
            enumerate(big)] == big


@pytest.mark.parametrize("NP", [4, 16, 64, 128])
def test_b3_piece_counts(cuda, NP):
    """Up to 64 pieces the output tile and the sources are in shared
    memory, beyond it in global memory: both hold to the plain version,
    with and without a 64 KB history."""
    rng = np.random.default_rng(400 + NP)
    n = NP * 1024
    srcs = [gen_text(n, seed=NP), gen_buffer(n - 77, 0.8, seed=NP),
            b"\xaa" * (n - 5), rng.bytes(min(n, 3000)) * (n // 3000 + 1),
            b"Q", gen_text(700, seed=1)]
    srcs = [s[:n] for s in srcs]
    streams = [blockcodec.compress(s) if i % 2 else
               blockcodec.compress_hc(s, 9) for i, s in enumerate(srcs)]
    arenas, out_lens = blockcodec.wave_split_batch(
        streams, max_pieces=NP, out_caps=[n] * len(srcs))
    gpu = _wave_both(cuda, arenas, out_lens)
    for i, s in enumerate(srcs):
        assert gpu[i, : len(s)].numpy().tobytes() == s
    hist = gen_text(65536, seed=NP + 1)
    linked = [(hist[-30000:-20000] + gen_text(n, seed=NP + 2))[:n]]
    arenas = np.zeros((1, NP, 1088), np.uint8)
    arena, k = blockcodec.wave_split(
        blockcodec.compress(linked[0], dict_prefix=hist), max_pieces=NP,
        out_cap=n, hist_len=65536)
    arenas[0, : arena.shape[0]] = arena
    gpu = _wave_both(cuda, arenas, np.array([k], np.int32),
                     np.frombuffer(hist, np.uint8).copy()[None])
    assert gpu[0, :k].numpy().tobytes() == linked[0]


def test_piece_route_on_card(cuda):
    """decode_dest "device": blocks over 256 KB decode as linked pieces,
    one B2 launch a wave, equal to the source and to the CPU's route."""
    hist = gen_text(70000, seed=50)
    blocks = [gen_text(600_000, seed=51), gen_buffer(300_000, 0.95, seed=52)]
    prefixes = [hist, None]
    comp = [blockcodec.compress(b, dict_prefix=d)
            for b, d in zip(blocks, prefixes)]
    waves = max(len(blockcodec.split_stream(c, out_cap=1 << 20)[1])
                for c in comp)
    be = TorchBackend(cuda)
    be.decode_dest = "device"
    before = decode_cuda.launches
    assert be.decompress_batch(comp, [1 << 20] * 2,
                               dict_prefixes=prefixes) == blocks
    assert decode_cuda.launches - before == waves
    cpu = TorchBackend("cpu")
    assert cpu._decompress_big_batch(comp, [1 << 20] * 2, prefixes) == blocks


def test_sortscan_decode_on_card_equals_cpu(cuda):
    """The sort/scan decoder's torch ops on the card give the CPU's
    out, out_lens and errs on every row, mutated streams included."""
    from lz4_tpu_torch.block import decode_sortscan
    rng = np.random.default_rng(53)
    srcs = [gen_text(65536, seed=54), gen_buffer(40000, 0.8, seed=55),
            b"z" * 65536, rng.bytes(30000)]
    streams = [blockcodec.compress(s) for s in srcs]
    for k in range(24):
        cc = bytearray(streams[k % 4])
        cc[int(rng.integers(0, len(cc)))] = int(rng.integers(0, 256))
        streams.append(bytes(cc[: int(rng.integers(1, len(cc) + 1))]))
    hist = gen_text(65536, seed=56)
    arrays = pack_blocks(streams, [hist] * len(streams),
                         cap=max(len(s) for s in streams), with_dict=True)
    got = decode_sortscan.decode_blocks(
        *to_device_batch(*arrays, device=cuda), cap_out=65536, has_dict=True)
    want = decode_sortscan.decode_blocks(
        *to_device_batch(*arrays, device="cpu"), cap_out=65536,
        has_dict=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert not want[2][:4].any()


# ------------------------------- probe kernels P1-P4, cut sizes and past wraps

@pytest.mark.parametrize("grid", [8, 16])
@pytest.mark.parametrize("variant", list(walk_probe.WALKS))
def test_walk_probe_matches_plain(cuda, variant, grid):
    w, n = walk_probe.inputs(n=4096)
    words, ns = torch.from_numpy(w).to(cuda), torch.from_numpy(n).to(cuda)
    acc, taken, cycles = walk_probe.walk(words, ns, variant, grid=grid,
                                         steps=512)
    pacc, ptaken = walk_probe.walk_plain(words.cpu(), ns.cpu(), variant,
                                         grid=grid, steps=512)
    assert torch.equal(acc.cpu(), pacc) and torch.equal(taken.cpu(), ptaken)
    assert cycles.shape == (grid,) and bool((cycles > 0).all())


def test_walk_probe_clamps_n(cuda):
    w, _ = walk_probe.inputs(rows=2, words=64)
    ns = torch.tensor([10**6, -5], dtype=torch.int32, device=cuda)
    words = torch.from_numpy(w).to(cuda)
    for variant in walk_probe.WALKS:
        if variant == "e":
            continue
        acc, taken, _ = walk_probe.walk(words, ns, variant)
        pacc, ptaken = walk_probe.walk_plain(words.cpu(), ns.cpu(), variant,
                                             grid=2)
        assert torch.equal(acc.cpu(), pacc), variant
        assert torch.equal(taken.cpu(), ptaken), variant


@pytest.mark.parametrize("variant,n", [("a", 66560), ("d", 66560),
                                       ("d_warp", 66560), ("e", 65536)])
def test_walk_probe_matches_plain_at_full_size(cuda, variant, n):
    """The whole 66,560-byte row the kernel copies to shared memory, and
    e at the tool's 26,214 steps (p wraps at 65,536)."""
    w, ns = walk_probe.inputs(n=n)
    acc, taken, _ = walk_probe.walk(torch.from_numpy(w).to(cuda),
                                    torch.from_numpy(ns).to(cuda), variant)
    pacc, ptaken, _ = walk_probe.walk(w, ns, variant, device="cpu")
    assert torch.equal(acc.cpu(), pacc) and torch.equal(taken.cpu(), ptaken)


@pytest.mark.parametrize("mode", ["arbitrary", "parallel"])
def test_burn_probe_matches_plain(cuda, mode):
    """__fmul_rn / __fadd_rn: the float32 rounding of the plain version,
    bit for bit."""
    x = torch.tensor([0.75], dtype=torch.float32, device=cuda)
    got, cycles = walk_probe.burn(x, mode, steps=2048)
    assert torch.equal(got.cpu(), walk_probe.burn_plain(x.cpu(), steps=2048))
    assert cycles.numel() == (1 if mode == "arbitrary" else 16)


@pytest.mark.parametrize("body", list(gather_probe.VARIANTS))
def test_gather_probe_matches_plain(cuda, body):
    d = gather_probe.inputs(b=2, r=64)
    steps = 512 if body == "hops" else None
    args = [torch.from_numpy(a) for a in gather_probe._args(body, d)]
    got, stats = gather_probe.gather(body, *(a.to(cuda) for a in args),
                                     steps=steps)
    want, _ = gather_probe.gather(body, *args, steps=steps)
    assert torch.equal(got.cpu(), want)
    assert (stats is None) == (body in ("lane", "flat", "row"))


@pytest.mark.parametrize("body", ["lane", "flat", "row", "hops"])
def test_gather_probe_wraps_out_of_range(cuda, body):
    rng = np.random.default_rng(61)
    shape = (2, 64, 128)
    a = rng.integers(-3 * 8192, 3 * 8192, shape, dtype=np.int32)
    b = rng.integers(-3 * 8192, 3 * 8192, shape, dtype=np.int32)
    steps = 256 if body == "hops" else None
    got, _ = gather_probe.gather(body, torch.from_numpy(a).to(cuda),
                                 torch.from_numpy(b).to(cuda), steps=steps)
    want, _ = gather_probe.gather(body, a, b, steps=steps, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("body", list(lane_probe.BODIES))
def test_lane_probe_matches_plain(cuda, body):
    d = lane_probe.inputs()
    src, idx = d[body]
    fn, kind, _, _, _ = lane_probe.BODIES[body]
    if fn == "gather":
        got = lane_probe.gather(kind, torch.from_numpy(src).to(cuda),
                                torch.from_numpy(idx).to(cuda))
        want = lane_probe.gather(kind, src, idx, device="cpu")
    elif fn == "loop":
        got, stats = lane_probe.loop(kind, torch.from_numpy(src).to(cuda), 64)
        want, _ = lane_probe.loop(kind, src, 64, device="cpu")
        assert bool((stats[:, 1] == 64).all())
    else:
        got, _ = lane_probe.wave(torch.from_numpy(src).to(cuda), 64)
        want, _ = lane_probe.wave(src, 64, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_wave_probe_past_the_ring_wrap(cuda):
    """1100 steps: the 512-row history wraps twice."""
    src, _ = lane_probe.inputs()["t_wave"]
    got, _ = lane_probe.wave(torch.from_numpy(src).to(cuda), 1100)
    want, _ = lane_probe.wave(src, 1100, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_lane_probe_full_int32_range(cuda):
    """Negative sources: floor mod, arithmetic shifts and int32 wrapping
    of the wave step and the loops, as the plain version's."""
    rng = np.random.default_rng(62)
    src = rng.integers(-2**31, 2**31, (512, 128), dtype=np.int32)
    dsrc = torch.from_numpy(src).to(cuda)
    for kind in ("a0_8", "a1_8", "2step", "a0_big", "onehot"):
        got, _ = lane_probe.loop(kind, dsrc, 48)
        want, _ = lane_probe.loop(kind, src, 48, device="cpu")
        assert torch.equal(got.cpu(), want), kind
    got, _ = lane_probe.wave(dsrc[:8].contiguous(), 200)
    want, _ = lane_probe.wave(src[:8], 200, device="cpu")
    assert torch.equal(got.cpu(), want)
    w = torch.from_numpy(src[:8]).to(cuda)
    assert torch.equal(lane_probe.gather("2step", w, w).cpu(),
                       lane_probe.gather("2step", src[:8], src[:8],
                                         device="cpu"))


INDEX_KINDS = ("random", "out-of-range", "negative", "full")
P4_SPLITS = [("a0", r) for r in (8, 16, 64, 512, 4096, 32768)] + [
    ("a1", 8), ("2step", 8)]
P1_SHAPES = [(1, 1, 1), (3, 8, 4), (2, 64, 128), (5, 512, 128),
             (1, 16, 8192), (1, 8192, 16)]


def _indices(kind, extent, shape, seed):
    rng = np.random.default_rng(seed)
    lo, hi = {"random": (0, extent), "out-of-range": (extent, 4 * extent),
              "negative": (-3 * extent, 0),
              "full": (-2**31, 2**31)}[kind]
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _on_card(a, cuda, offset):
    """a on the card; with offset 1, a view one word past a 16-byte
    aligned start (the kernels' 4-byte path)."""
    t = torch.from_numpy(a)
    if not offset:
        return t.to(cuda)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("ikind", INDEX_KINDS)
@pytest.mark.parametrize("kind,rows", P4_SPLITS,
                         ids=[f"{k}-{r}" for k, r in P4_SPLITS])
def test_p4_gather_matches_plain_at_split_shapes(cuda, kind, rows, ikind,
                                                 offset):
    rng = np.random.default_rng(rows)
    src = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)
    extent = {"a0": rows, "a1": 128, "2step": 1024}[kind]
    idx = _indices(ikind, extent, (rows, 128), rows + 1)
    got = lane_probe.gather(kind, _on_card(src, cuda, offset),
                            _on_card(idx, cuda, offset))
    want = lane_probe.gather(kind, src, idx, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("ikind", INDEX_KINDS)
@pytest.mark.parametrize("shape", P1_SHAPES,
                         ids=["x".join(map(str, s)) for s in P1_SHAPES])
@pytest.mark.parametrize("body", ["lane", "row", "flat"])
def test_p1_gather_matches_plain_at_split_shapes(cuda, body, shape, ikind,
                                                 offset):
    b, r, c = shape
    rng = np.random.default_rng(r * c + b)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    extent = {"lane": c, "row": r, "flat": r * c}[body]
    idx = _indices(ikind, extent, shape, b + r + c)
    got, stats = gather_probe.gather(body, _on_card(x, cuda, offset),
                                     _on_card(idx, cuda, offset))
    want, _ = gather_probe.gather(body, x, idx, device="cpu")
    assert stats is None and torch.equal(got.cpu(), want)


def test_gather_wrappers_launch_once_and_allocate_one_output(cuda):
    """Each gather call: one launch, one allocation (its output)."""
    x = torch.zeros((2, 64, 128), dtype=torch.int32, device=cuda)
    src = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    s8 = src[:8].contiguous()
    calls = [(gather_probe, lambda b=b: gather_probe.gather(b, x, x))
             for b in ("lane", "row", "flat")]
    calls += [(lane_probe, lambda: lane_probe.gather("a0", src, src)),
              (lane_probe, lambda: lane_probe.gather("a1", s8, s8)),
              (lane_probe, lambda: lane_probe.gather("2step", s8, s8))]
    for mod, call in calls:
        call()
        torch.cuda.synchronize()
        before = mod.launches
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        call()
        assert mod.launches == before + 1
        assert (torch.cuda.memory_stats()["allocation.all.allocated"]
                == allocs + 1)
    torch.cuda.synchronize()


def test_gather_entry_leaves_bad_inputs_to_the_checks(cuda):
    """The C entry returns None on what it does not take; the wrappers'
    Python checks then raise as before, and a mixed CUDA / numpy call is
    moved to the card and launched."""
    x = torch.zeros((1, 64, 128), dtype=torch.int32, device=cuda)
    src = torch.zeros((16, 128), dtype=torch.int32, device=cuda)
    assert gather_probe._load_entry()(x, x.to(torch.int64), 0) is None
    assert lane_probe._load_entry()(src, src, 1) is None    # a1: 8 rows
    with pytest.raises(TypeError, match="int32"):
        gather_probe.gather("lane", x, x.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        gather_probe.gather("row", x, x.transpose(1, 2).contiguous()
                            .transpose(1, 2))
    with pytest.raises(ValueError, match="8 rows"):
        lane_probe.gather("a1", src, src)
    with pytest.raises(ValueError, match="power of two"):
        lane_probe.gather("a0", src[:12].contiguous(), src[:12].contiguous())
    idx = np.arange(64 * 128, dtype=np.int32).reshape(1, 64, 128)
    got, _ = gather_probe.gather("flat", x + 5, idx)
    assert got.is_cuda and bool((got == 5).all())


def test_probe_wrappers_raise_on_wrong_layout(cuda):
    words = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    ns = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        walk_probe.walk(words.to(torch.int64), ns, "a")
    with pytest.raises(ValueError, match="inputs on"):
        walk_probe.walk(words, ns.cpu(), "a")
    with pytest.raises(ValueError, match="ns must be"):
        walk_probe.walk(words, ns[:1], "a")
    with pytest.raises(ValueError, match="contiguous"):
        walk_probe.walk(torch.zeros((64, 2), dtype=torch.int32,
                                    device=cuda).t(), ns, "a")
    with pytest.raises(TypeError, match="float32"):
        walk_probe.burn(torch.ones(1, device=cuda, dtype=torch.float64),
                        "parallel")
    x = torch.zeros((1, 64, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="inputs on"):
        gather_probe.gather("lane", x, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        gather_probe.gather("row", x, x[:, :32].contiguous())
    with pytest.raises(ValueError, match="powers of two"):
        gather_probe.gather("flat", x[:, :48].contiguous(),
                            x[:, :48].contiguous())
    src = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        lane_probe.loop("base", src.to(torch.int16), 4)
    with pytest.raises(ValueError, match="power of two"):
        lane_probe.loop("a0_big", torch.zeros((24, 128), dtype=torch.int32,
                                              device=cuda), 4)
    with pytest.raises(ValueError, match="inputs on"):
        lane_probe.gather("a0", src, src.cpu())
    with pytest.raises(ValueError, match="int32\\[8, 128\\]"):
        lane_probe.wave(torch.zeros((16, 128), dtype=torch.int32,
                                    device=cuda), 4)


@pytest.mark.parametrize("argv", [["--kernels", "--wave"], []],
                         ids=["kernels-wave", "sortscan"])
def test_torture_short_run_on_card(cuda, capsys, argv):
    """The fuzzer's device legs on the card for a few seconds: no
    disagreement, and mutated streams reach the device decoder."""
    import json
    before = torture.read_launches()
    assert torture.main(["--seconds", "5", "--seed", "7", *argv]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    c = res["torture"]["counters"]
    leg = "B2" if argv else "sortscan"
    assert c.get(f"mutated.{leg}", 0) > 0
    assert c.get("disagreements", 0) == 0
    if argv:
        after = torture.read_launches()
        assert after["B2"] > before["B2"] and after["B3"] > before["B3"]


def test_fullbench_short_run_on_card(cuda, capsys):
    import json
    stages = ("noop,cumsum,sort2,scan_4k_u4,encode_mixed,ejump_mixed,"
              "decode_mixed")
    assert fullbench.main(["--b", "2", "--block", "4096", "--seconds", "0",
                           "--level", "2", "--stages", stages]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["card"]
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["stage"] for r in rows] == stages.split(",")
    assert all(r["ms"] > 0 and r["host_ms"] > 0 for r in rows)
