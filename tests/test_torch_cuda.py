"""Kernels B1-B6 and the probe kernels P1-P4 against their plain PyTorch
versions on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. On a machine with
the card (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (LZ4 output is deterministic integers).
"""
import functools

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
from lz4_tpu_torch import _build
from lz4_tpu_torch.probes import _common as cm
from lz4_tpu_torch.probes import (fullbench, gather_probe, lane_probe, sass,
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


def _linked(make, n, seed):
    """(block, history): n bytes that go on from their 64 KB history, as
    the next block of a linked frame does."""
    data = make(65536 + n, seed)
    return data[65536:], data[:65536]


@functools.lru_cache(maxsize=1)
def _b1_cases():
    """(blocks, prefixes, cap, kwargs) for `test_b1_solo_and_device_tables`.
    The `window_` cases are the dict solo path's window (CPU model:
    tests/test_torch_encode_lockstep.py): linked rows twice the lead with
    a full, a partial and an empty history; a row equal to its history
    and one shifted by a byte (offset 65,535, the lowest history byte the
    window must hold); zero rows, whose one match runs past the lead (the
    forward count stages on), and random ones, whose probes run past it
    (the window parse stops, and the kernel parses them again with the
    row staged); linked rows with a 12 KB run of zeros or of random bytes
    in the middle, beside one without; rows of an odd width, which are
    not staged."""
    rng = np.random.default_rng(81)
    rand = _random_blocks(rng, 10, 8192)
    hist = gen_text(70000, seed=82)
    partial = [hist[-int(k):] or None
               for k in rng.integers(0, 70000, len(rand))]
    odd = _random_blocks(rng, 8, 5003) + [b"", b"x" * 5003]
    odd_hist = [hist[-int(k):] or None
                for k in rng.integers(0, 70000, len(odd))]
    walk = gen_hash_walk(70000, seed=83)
    coll = [gen_hash_walk(16384, seed=84), gen_slot_words(16384, seed=84),
            gen_slot_words(3000, pool=4, seed=85), b"", b"q" * 13]
    coll_hist = [walk, walk[-5000:], None, walk, walk[-1:]]
    full = [gen_text(65536, seed=86), gen_buffer(65536, 0.7, seed=87),
            bytes(65536), rng.bytes(65536)]
    text, text_hist = _linked(lambda n, s: gen_text(n, seed=s), 16384, 88)
    mixed, mixed_hist = _linked(lambda n, s: gen_buffer(n, 0.7, seed=s),
                                16384, 89)
    linked = [text, mixed, gen_text(16384, seed=90)]
    linked_hist = [text_hist, mixed_hist[-3000:], None]
    edge = rng.bytes(65536)
    mid, mid_hist = _linked(lambda n, s: gen_text(n, seed=s), 65536, 93)
    far = [mid[:32768] + fill + mid[32768 + 12288:]
           for fill in (bytes(12288), rng.bytes(12288))] + [mid]
    odd_text, odd_hist = _linked(lambda n, s: gen_text(n, seed=s), 20003, 91)
    return {
        "random": (rand, None, 8192, {}),
        "random_max_acceleration": (rand, None, 8192,
                                    {"acceleration": 65537}),
        "dict_partial": (rand, partial, 8192, {}),
        "dict_max_acceleration": (rand, partial, 8192,
                                  {"acceleration": 65537}),
        "max_dist": (rand, None, 8192, {"max_dist": 3000}),
        "dict_max_dist_stride_1": (rand, partial, 8192,
                                   {"max_dist": 3000, "dict_stride": 1}),
        "odd_width": (odd, None, 5003, {}),
        "odd_width_dict": (odd, odd_hist, 5003, {"acceleration": 3}),
        "collisions": (coll, None, 16384, {}),
        "collisions_max_acceleration": (coll, None, 16384,
                                        {"acceleration": 65537}),
        "collisions_dict": (coll, coll_hist, 16384, {}),
        "full_rows": (full, None, 65536, {}),
        "full_rows_dict": (full, [hist, None, hist[-100:], hist], 65536, {}),
        "window_linked": (linked, linked_hist, 16384, {}),
        "window_linked_max_dist_stride_1": (
            linked, linked_hist, 16384,
            {"max_dist": 2000, "dict_stride": 1, "acceleration": 8}),
        "window_linked_max_acceleration": (linked, linked_hist, 16384,
                                           {"acceleration": 65537}),
        "window_history_edges": ([edge, edge[1:] + b"x"], [edge, edge],
                                 65536, {"dict_stride": 1}),
        "window_zero_and_random": (
            [bytes(65536), bytes(65536), rng.bytes(65536)],
            [bytes(65536), None, rng.bytes(65536)], 65536, {}),
        "window_odd_width": ([odd_text], [odd_hist], 20003, {}),
        "window_far_midblock": (far, [mid_hist] * 3, 65536, {}),
    }


@pytest.mark.parametrize("case", [
    "random", "random_max_acceleration", "dict_partial",
    "dict_max_acceleration", "max_dist", "dict_max_dist_stride_1",
    "odd_width", "odd_width_dict", "collisions",
    "collisions_max_acceleration", "collisions_dict", "full_rows",
    "full_rows_dict", "window_linked", "window_linked_max_dist_stride_1",
    "window_linked_max_acceleration", "window_history_edges",
    "window_zero_and_random", "window_odd_width", "window_far_midblock"])
def test_b1_solo_and_device_tables(cuda, case):
    """B1's two launch shapes, byte for byte against the plain version:
    calls of 1, len(blocks), 64 and SMs blocks run solo (a whole SM a
    block), SMs + 1 on the device tables; row r holds block r mod
    len(blocks). `smem_launches` rises by one exactly on the solo
    calls."""
    blocks, prefixes, cap, kw = _b1_cases()[case]
    has_dict = prefixes is not None
    arrays = pack_blocks(blocks, prefixes, cap=cap, with_dict=has_dict)
    po, pc, pt = encode_cuda.encode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_n=cap, **kw)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in (1, len(blocks), 64, sms, sms + 1):
        idx = np.arange(B) % len(blocks)
        rows = [None if a is None else a[idx] for a in arrays]
        solo, card_sms = encode_cuda.plan(B, has_dict)
        assert (solo, card_sms) == (B <= sms, sms)
        n0, s0 = encode_cuda.launches, encode_cuda.smem_launches
        go, gc, gt = (x.cpu() for x in encode_cuda.encode_blocks(
            *to_device_batch(*rows, device=cuda), cap_n=cap, **kw))
        assert (encode_cuda.launches, encode_cuda.smem_launches) == (
            n0 + 1, s0 + solo)
        assert torch.equal(gc, pc[idx]) and torch.equal(gt, pt[idx]), B
        for r, i in enumerate(idx.tolist()):
            n = int(pc[i])
            assert torch.equal(go[r, :n], po[i, :n]), (B, r)


def test_b1_linked_cell_batch(cuda):
    """The lz4f-linked-64k.compress cell's call: 64 blocks of 64 KB, each
    with the 64 KB before it in its 128 KB row of the silesia-like
    corpus as its history, through `TorchBackend.compress_batch`. It
    runs solo in dict mode (`launches`, `smem_launches` and
    `dict_launches` each rise by one; the same blocks without prefixes
    leave `dict_launches` as it was), and sampled rows equal the plain
    version byte for byte and, joined with their history, decode by the
    benchmark's strict reference to their rows."""
    from benchmark import corpus, reference, reference_linked
    spec = corpus.load_spec("silesia-like")
    data, _ = corpus.make_corpus(spec, 2650000017, spec["stratum_blocks"],
                                 131072, cuda)
    host = data[:64].cpu().numpy()
    del data
    prefixes = [row[:65536].tobytes() for row in host]
    blocks = [row[65536:].tobytes() for row in host]
    assert encode_cuda.plan(64, True)[0]
    be = TorchBackend(cuda)

    def counts():
        return (encode_cuda.launches, encode_cuda.smem_launches,
                encode_cuda.dict_launches)
    n0, s0, d0 = counts()
    linked = be.compress_batch(blocks, level=1, acceleration=1,
                               dict_prefixes=prefixes,
                               favor_dec_speed=False)
    assert counts() == (n0 + 1, s0 + 1, d0 + 1)
    alone = be.compress_batch(blocks, level=1, acceleration=1,
                              dict_prefixes=[None] * 64)
    assert counts() == (n0 + 2, s0 + 2, d0 + 1)
    assert sum(map(len, linked)) < sum(map(len, alone))
    rows = [0, 21, 42, 63]
    arrays = pack_blocks([blocks[i] for i in rows],
                         [prefixes[i] for i in rows], cap=65536,
                         with_dict=True)
    po, pc, _ = encode_cuda.encode_blocks_plain(
        *to_device_batch(*arrays, device="cpu"), cap_n=65536)
    for j, i in enumerate(rows):
        assert po[j, : pc[j]].numpy().tobytes() == linked[i], i
        joined = reference_linked.join(prefixes[i], linked[i])
        assert reference.decode_block(joined, 131072) == host[i].tobytes()


def test_b1_count_build_on_the_linked_cell_batch(cuda):
    """The counting build (`LZ4T_B1_COUNT`, as `probes/b1_split.py` runs
    it) on `test_b1_linked_cell_batch`'s 64 rows: its streams are the
    shipping kernel's, the window served every read of the parse (no
    block left it), every block staged its bytes past the lead, and some
    reads were of the history. On four of
    the rows its figures are the CPU model's (`LockstepModel`), read for
    read."""
    from benchmark import corpus
    from lz4_tpu_torch.probes import b1_split
    spec = corpus.load_spec("silesia-like")
    data, _ = corpus.make_corpus(spec, 2650000017, spec["stratum_blocks"],
                                 131072, cuda)
    src = data[:64, 65536:].contiguous()
    hist = data[:64, :65536].contiguous()
    del data
    lens = torch.full((64,), 65536, dtype=torch.int32, device=cuda)
    count = b1_split.DICT_BUILDS["count"]
    _build.build(["encode_serial"], count)
    assert b1_split.path_of(count, 64, True) == "solo"
    run, outs = b1_split._launcher(_build.load("encode_serial", count), src,
                                   lens, hist, lens)
    run()
    counts = b1_split.read_counts(count, 64, per_block=True)
    ref = encode_cuda.encode_blocks(src, lens, hist, lens, cap_n=65536)
    assert b1_split._same(outs, ref)
    assert counts["left"] == 0 and counts["hist_reads"] > 0
    assert counts["staged"] == 64 * (65536 - encode_cuda.LEAD)
    for i in (0, 21, 42, 63):
        *_, m = encode_cuda.encode_blocks_lockstep(
            src[i: i + 1].cpu(), lens[:1].cpu(), hist[i: i + 1].cpu(),
            lens[:1].cpu(), cap_n=65536)
        assert counts["blocks"][i] == (m.hist_reads, m.block_reads,
                                       m.left, m.staged), i


@pytest.mark.parametrize("fill", ["zero", "random"])
def test_b1_count_build_leaves_the_window_on_a_literal_run(cuda, fill):
    """`test_b1_linked_cell_batch`'s 64 rows with a 12 KB run of zeros or
    of random bytes planted in the middle of the first block
    (`b1_split --far one`): the counting build's streams are the shipping
    kernel's, and the block's equals the plain version. The zeros' match
    runs past the lead, but its forward count stages on, so the block
    stays in the window; the random bytes' literal run takes the probes
    to the served part's end, so that block alone leaves the window and
    goes on with its row. The block's figures are the CPU model's, read
    for read, up to where it leaves."""
    from benchmark import corpus
    from lz4_tpu_torch.probes import b1_split
    spec = corpus.load_spec("silesia-like")
    data, _ = corpus.make_corpus(spec, 2650000017, spec["stratum_blocks"],
                                 131072, cuda)
    src = data[:64, 65536:].contiguous()
    hist = data[:64, :65536].contiguous()
    del data
    lens = torch.full((64,), 65536, dtype=torch.int32, device=cuda)
    b1_split.plant_far([(src,)], "one", fill, 7)
    count = b1_split.DICT_BUILDS["count"]
    _build.build(["encode_serial"], count)
    run, outs = b1_split._launcher(_build.load("encode_serial", count), src,
                                   lens, hist, lens)
    run()
    counts = b1_split.read_counts(count, 64, per_block=True)
    ref = encode_cuda.encode_blocks(src, lens, hist, lens, cap_n=65536)
    assert b1_split._same(outs, ref)
    assert counts["left"] == counts["blocks"][0][2] == (fill == "random")
    one = [x[:1].cpu() for x in (src, lens, hist, lens)]
    po, pc, pt = encode_cuda.encode_blocks_plain(*one, cap_n=65536)
    n = int(pc[0])
    assert (int(ref[1][0]), int(ref[2][0])) == (n, int(pt[0]))
    assert torch.equal(ref[0][0, :n].cpu(), po[0, :n])
    *_, m = encode_cuda.encode_blocks_lockstep(*one, cap_n=65536)
    assert counts["blocks"][0] == (m.hist_reads, m.block_reads, m.left,
                                   m.staged)


def test_b1_resources_as_chip_smoke_reads_them(cuda):
    """B1's kernels as `chip_smoke.py` reports them: the no-dict solo
    kernel keeps its 72 registers and 213,024 bytes of shared memory, the
    dict solo kernel's window fits a CTA's 232,448, and no kernel
    spills."""
    import chip_smoke
    _build.build(["encode_serial"])
    k = chip_smoke.b1_resources()["kernels"]
    assert set(k) == {"solo", "solo dict", "tables", "tables dict"}
    assert (k["solo"]["registers"], k["solo"]["dynamic_smem"]) == (72,
                                                                    213024)
    assert k["solo dict"]["dynamic_smem"] == 229408 <= 232448
    assert [e["spill_stores"] for e in k.values()] == [0] * 4


def test_b1_window_on_a_4mb_block(cuda):
    """A 4 MB block through the engine's big-block route: 64 linked 64 KB
    segments in one dict call, which runs solo on the window, equal to
    the CPU backend's plain version and decoding to the block."""
    data = b"".join(gen_text(1 << 20, seed=92 + k) if k % 2 else
                    gen_buffer(1 << 20, 0.6, seed=92 + k) for k in range(4))
    gpu, cpu = TorchBackend(cuda), TorchBackend("cpu")
    n0, s0, d0 = (encode_cuda.launches, encode_cuda.smem_launches,
                  encode_cuda.dict_launches)
    big = gpu.compress_batch([data])
    assert (encode_cuda.launches, encode_cuda.smem_launches,
            encode_cuda.dict_launches) == (n0 + 1, s0 + 1, d0 + 1)
    assert big == cpu.compress_batch([data])
    assert gpu.decompress_batch(big, [4 << 20]) == [data]


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


def _hc_c(row, level, favor):
    """The host C encoder's stream for B5's settings."""
    if favor:
        return blockcodec.compress_lazy(row, encode_hc.depth_for(level),
                                        favor_dec_speed=True)
    return blockcodec.compress_hc(row, level)


def _hc_wide(cuda, src, lens, **kw):
    """B5 on the card at width 1: the batch repeated past the card's
    2-CTA clusters (one launch, not a cluster launch); returns the first
    copy's streams, every copy's equal to them."""
    B = len(lens)
    with torch.cuda.device(cuda):
        _, clusters = encode_hc.plan(B)
    reps = clusters // B + 1
    n0, c0 = encode_hc.launches, encode_hc.cluster_launches
    go, gc, _ = (x.cpu() for x in encode_hc.encode_blocks_hc(
        torch.from_numpy(np.tile(src, (reps, 1))).to(cuda),
        torch.from_numpy(np.tile(lens, reps)).to(cuda), **kw))
    assert (encode_hc.launches, encode_hc.cluster_launches) == (n0 + 1, c0)
    got = [go[i, :n].numpy().tobytes() for i, n in enumerate(gc.tolist())]
    assert all(got[r * B: (r + 1) * B] == got[:B] for r in range(reps))
    return got[:B]


@pytest.mark.parametrize("favor", [False, True])
def test_b5_full_rows_of_zeros_and_patterns(cuda, favor):
    """64 KB rows at levels 3 and 9: counts that run the whole row, and
    the repeat-pattern analysis on periodic rows; at width 2 (a 2-CTA
    cluster a block) and at width 1 (the batch repeated past the card's
    clusters), equal to the plain version and the host C encoder."""
    rows = [bytes(65536), b"abab" * 16384, b"abcd" * 16384,
            (b"xyz" * 21846)[:65536],
            b"\x07" * 30000 + b"ab" * 10000 + bytes(15536)]
    src, lens, _, _ = pack_blocks(rows, cap=65536)
    for level in (3, 9):
        c0 = encode_hc.cluster_launches
        out = _hc_both(cuda, src, lens, cap_n=65536, level=level,
                       favor_dec_speed=favor)
        assert encode_hc.cluster_launches == c0 + 1
        assert _hc_wide(cuda, src, lens, cap_n=65536, level=level,
                        favor_dec_speed=favor) == out
        for row, s in zip(rows, out):
            assert blockcodec.decompress(s, len(row)) == row
            assert s == _hc_c(row, level, favor)


def _runs_row():
    """Runs of 5-304 equal bytes over 7 values, then a run of q: at 128
    and at 256 parts a repair's list fills at level 9, so the block falls
    back to the serial parse (the lockstep model says so)."""
    row = b"".join(bytes([i % 7]) * (i % 300 + 5) for i in range(400))
    return row[:65536].ljust(65536, b"q")


def test_b5_serial_fallback_at_both_widths(cuda):
    """A block whose repair list fills falls back to the serial parse in
    rank 0 at width 2 (the counting build counts the fallback, at width
    2), and at width 1; the streams equal the host C encoder's."""
    from lz4_tpu_torch.probes import b5_split
    rows = [_runs_row(), gen_text(65536, seed=8)]
    src, lens, _, _ = pack_blocks(rows, cap=65536)
    counts = b5_split._block_counts(torch.from_numpy(src).to(cuda),
                                    torch.from_numpy(lens).to(cuda), 9)
    keys = b5_split.COUNT_KEYS
    assert counts[0, keys.index("fallbacks")] == 1
    assert counts[:, keys.index("width")].tolist() == [2, 2]
    for level, favor in ((9, False), (3, False), (9, True)):
        c0 = encode_hc.cluster_launches
        go, gc, _ = (x.cpu() for x in encode_hc.encode_blocks_hc(
            torch.from_numpy(src).to(cuda), torch.from_numpy(lens).to(cuda),
            cap_n=65536, level=level, favor_dec_speed=favor))
        assert encode_hc.cluster_launches == c0 + 1
        got = [go[i, :n].numpy().tobytes() for i, n in enumerate(gc.tolist())]
        for row, s in zip(rows, got):
            assert s == _hc_c(row, level, favor), (level, favor)
        assert _hc_wide(cuda, src, lens, cap_n=65536, level=level,
                        favor_dec_speed=favor) == got


#: batch sizes up to 66 (an H100 SXM's 2-CTA clusters) at
#: width 2, the neighbours past it at width 1
B5_WIDTH_BATCHES = [1, 2, 64, 66, 67, 132, 300]


def _b5_width_blocks(B, cap, seed):
    """B blocks: rows of zeros and short periods (the pattern path), then
    random blocks of every kind."""
    rng = np.random.default_rng(seed)
    pats = [bytes(cap), (b"ab" * cap)[:cap], (b"abc" * cap)[:cap],
            b"\x07" * (cap // 2) + (b"xy" * cap)[: cap - cap // 2],
            ((b"ab" * 20 + b"Q") * cap)[:cap]]
    return (pats + _random_blocks(rng, B, cap))[:B]


@pytest.mark.parametrize("B", B5_WIDTH_BATCHES)
def test_b5_widths_match_plain_and_c(cuda, B):
    """A call of B blocks runs at width 2 where the card holds B 2-CTA
    clusters of the kernel, else at width 1; at either width B5's csizes,
    trailing and streams equal the plain version's and the host C
    encoder's, at levels 3 and 9 and with favor_dec_speed, and
    `cluster_launches` counts the width-2 launches alone."""
    cap = 4096
    with torch.cuda.device(cuda):
        width, clusters = encode_hc.plan(B)
    assert width == (2 if B <= clusters else 1)
    if clusters == 66:                    # an H100 SXM
        assert width == (2 if B <= 66 else 1)
    blocks = _b5_width_blocks(B, cap, seed=B)
    src, lens, _, _ = pack_blocks(blocks, cap=cap)
    for level, favor in ((3, False), (9, False), (9, True)):
        n0, c0 = encode_hc.launches, encode_hc.cluster_launches
        out = _hc_both(cuda, src, lens, cap_n=cap, level=level,
                       favor_dec_speed=favor)
        assert encode_hc.launches == n0 + 1
        assert encode_hc.cluster_launches == c0 + (width == 2)
        for row, s in zip(blocks, out):
            assert s == _hc_c(row, level, favor), (level, favor)


def test_b5_cell_batch_at_both_widths(cuda):
    """A whole 64-block batch of the lz4hc9-64k.compress cell's corpus
    (benchmark/corpora/silesia-like.json, the cell's batch order) at
    levels 9 and 3: width 2 equal to the host C encoder block for block,
    and to width 1 (the batch with three more blocks); the plain version
    on two rows (csizes, trailing and bytes)."""
    from benchmark import corpus
    spec = corpus.load_spec("silesia-like")
    data, _ = corpus.make_corpus(spec, 2718281828, spec["stratum_blocks"],
                                 65536, cuda)
    host = data[:67].cpu().numpy()
    lens = np.full(67, 65536, np.int32)
    for level in (9, 3):
        c0 = encode_hc.cluster_launches
        go, gc, gt = (x.cpu() for x in encode_hc.encode_blocks_hc(
            data[:64], torch.from_numpy(lens[:64]).to(cuda), cap_n=65536,
            level=level))
        assert encode_hc.cluster_launches == c0 + 1
        wide = [go[i, :n].numpy().tobytes() for i, n in enumerate(gc.tolist())]
        for i in range(64):
            assert wide[i] == blockcodec.compress_hc(host[i].tobytes(),
                                                     level), (level, i)
        assert _hc_wide(cuda, host[:64], lens[:64], cap_n=65536,
                        level=level)[:64] == wide
        w1, _, _ = (x.cpu() for x in encode_hc.encode_blocks_hc(
            data[:67], torch.from_numpy(lens).to(cuda), cap_n=65536,
            level=level))
        assert encode_hc.cluster_launches == c0 + 1
        assert [w1[i, :n].numpy().tobytes()
                for i, n in enumerate(gc.tolist())] == wide
        rows = [0, 63]
        po, pc, pt = encode_hc.encode_blocks_hc_plain(
            torch.from_numpy(host[rows]), torch.from_numpy(lens[rows]),
            cap_n=65536, level=level)
        assert torch.equal(pc, gc[rows]) and torch.equal(pt, gt[rows])
        for j, i in enumerate(rows):
            assert po[j, : pc[j]].numpy().tobytes() == wide[i]


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
    n, c = encode_hc.launches, encode_hc.cluster_launches
    for level in (3, 9):
        ours = gpu.compress_batch(blocks, level=level)
        assert ours == HostBackend().compress_batch(blocks, level=level)
        assert gpu.decompress_batch(ours, [65536] * len(blocks)) == blocks
    assert encode_hc.launches == n + 2 and gpu.hc_encoded == 2
    assert encode_hc.cluster_launches == c + 2    # 8 blocks: width 2


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


def _staging_cases():
    """(level, blocks, dict_prefixes) on the staged routes: B1 and level 2
    on a plain batch, a dict batch and a batch with a block over 64 KB;
    B5 on a plain batch (an HC dict batch or big block goes to the host
    tier, which stages nothing)."""
    data = gen_text(200000, seed=31) + gen_buffer(100000, 0.7, seed=32)
    plain = [data[i: i + 20000] for i in range(0, 160000, 20000)]
    dicts = [data[i + 7: i + 70007] for i in range(0, 160000, 20000)]
    big = [data[:150000], data[150000:160000]]
    return ([(lv, plain, None) for lv in (1, 2, 9)]
            + [(lv, plain, dicts) for lv in (1, 2)]
            + [(lv, big, None) for lv in (1, 2)])


@pytest.mark.parametrize("case", range(7))
def test_staged_calls_match_cpu(cuda, case):
    """The staged path's bytes equal `TorchBackend("cpu")`'s, one
    `pinned_calls` a call."""
    level, blocks, prefixes = _staging_cases()[case]
    gpu = TorchBackend(cuda)
    ours = gpu.compress_batch(blocks, level=level, dict_prefixes=prefixes)
    assert ours == TorchBackend("cpu").compress_batch(
        blocks, level=level, dict_prefixes=prefixes)
    assert gpu.pinned_calls == 1
    assert HostBackend().decompress_batch(
        ours, [len(b) for b in blocks], dict_prefixes=prefixes) == blocks


@pytest.mark.parametrize("level", [1, 2, 9])
def test_staged_pad_is_clean_after_full_rows(cuda, level):
    """Short blocks right after full random 64 KB blocks, on one backend:
    the same bytes as the CPU's freshly zeroed arrays (a stale pad in
    the reused page-locked rows would change them)."""
    rng = np.random.default_rng(level)
    full = [rng.bytes(65536) for _ in range(64)]
    short = [gen_text(int(n), seed=int(n))
             for n in rng.integers(4096, 9000, 64)]
    kw = {} if level == 9 else {"dict_prefixes": [rng.bytes(65536)] * 64}
    gpu, cpu = TorchBackend(cuda), TorchBackend("cpu")
    for blocks in (full, short):
        got = gpu.compress_batch(blocks, level=level, **kw)
        if blocks is short:
            assert got == cpu.compress_batch(blocks, level=level, **kw)
        kw = {"dict_prefixes": [b"ab"] * 64} if kw else kw
    assert gpu.pinned_calls == 2


@pytest.mark.parametrize("level", [1, 9])
def test_staged_steps_in_order_and_copies_pinned(cuda, level):
    """On the card a call's steps come in order, one after another, and
    every copy of the call runs from or to page-locked memory."""
    blocks = [gen_text(65536, seed=s) for s in range(8)]
    gpu = TorchBackend(cuda)
    want = gpu.compress_batch(blocks, level=level)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        got = gpu.compress_batch(blocks, level=level)
    assert got == want and gpu.pinned_calls == 2
    cpu_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU]
    steps = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu_events if e.name.startswith("lz4t.")
                   and e.name != "lz4t.compress_batch")
    assert [n for _, _, n in steps] == [
        "lz4t.pack", "lz4t.h2d", "lz4t.launch", "lz4t.d2h", "lz4t.to_bytes"]
    for (_, e1, _), (s2, _, _) in zip(steps, steps[1:]):
        assert e1 <= s2
    copies = {e.name for e in prof.events() if e.name.startswith("Memcpy")}
    assert copies and all("Pinned" in n for n in copies), copies


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


BLOCK_NS = [0, 1, 3, 7, 8, 4 * walk_probe.BLOCK - 1, 4 * walk_probe.BLOCK,
            4 * walk_probe.BLOCK + 1, 65536, 66560, 10**6]


@pytest.mark.parametrize("n", BLOCK_NS)
@pytest.mark.parametrize("variant", ["b", "c", "d"])
def test_blocked_walks_match_plain(cuda, variant, n):
    """The blocked walks (one exit test a block of `BLOCK` steps) at the
    edges of a block's reach, the tool's 65,536 bytes, the whole row and
    past it: acc and each grid step's steps equal the plain version's and
    the host replay of the kernel's control flow (`walk_model`)."""
    w, _ = walk_probe.inputs(rows=2)
    ns = np.full(2, n, np.int32)
    acc, taken, cycles = walk_probe.walk(torch.from_numpy(w).to(cuda),
                                         torch.from_numpy(ns).to(cuda),
                                         variant, grid=4)
    pacc, ptaken = walk_probe.walk_plain(torch.from_numpy(w),
                                         torch.from_numpy(ns), variant,
                                         grid=4)
    assert torch.equal(acc.cpu(), pacc) and torch.equal(taken.cpu(), ptaken)
    for g in range(4):
        got, steps, _ = walk_probe.walk_model(w[g % 2], n, variant)
        assert (got, steps) == (int(acc[g % 2]) & 0xFFFFFFFF,
                                int(taken[g]))
    assert bool((cycles >= 0).all())


@pytest.mark.parametrize("n", BLOCK_NS)
@pytest.mark.parametrize("build", [(k, b) for k, v in
                                   walk_probe.INFLIGHT.items() for b in v])
def test_inflight_builds_match_plain(cuda, build, n):
    """The builds that vary the loads in flight (d's blocks on 2, 4 or 8
    chains at a time, b's next loads first) compute what the default
    build computes: acc and steps equal the plain version's."""
    kind, name = build
    w, _ = walk_probe.inputs(rows=2)
    ns = np.full(2, n, np.int32)
    acc, taken, _ = walk_probe.walk(
        torch.from_numpy(w).to(cuda), torch.from_numpy(ns).to(cuda), kind,
        grid=4, defines=walk_probe.INFLIGHT[kind][name])
    pacc, ptaken = walk_probe.walk_plain(torch.from_numpy(w),
                                         torch.from_numpy(ns), kind, grid=4)
    assert torch.equal(acc.cpu(), pacc) and torch.equal(taken.cpu(), ptaken)


@pytest.mark.parametrize("nit", [0, 1, 7, 64, lane_probe.NIT])
@pytest.mark.parametrize("body", lane_probe.CHAIN_LOOPS)
def test_chain_loops_match_plain(cuda, body, nit):
    """base, a0_8 and a1_8 at one (row, lane) chain a thread, up to the
    probe's 65,536 steps: acc equal to the plain version's, stats one row
    a CTA (8) with the steps of every chain."""
    src, _ = lane_probe.inputs()[f"t_{body}"]
    got, stats = lane_probe.loop(body, torch.from_numpy(src).to(cuda), nit)
    want, _ = lane_probe.loop(body, src, nit, device="cpu")
    assert torch.equal(got.cpu(), want)
    st = stats.cpu()
    assert st.shape == (8, 2) and st[:, 1].tolist() == [nit] * 8
    assert bool((st[:, 0] >= 0).all())


@pytest.mark.parametrize("mode", ["arbitrary", "parallel"])
def test_burn_probe_matches_plain(cuda, mode):
    """__fmul_rn / __fadd_rn: the float32 rounding of the plain version,
    bit for bit; "arbitrary" runs the 16 grid steps on one CTA (its
    lanes), "parallel" on 16 CTAs."""
    x = torch.tensor([0.75], dtype=torch.float32, device=cuda)
    got, stats = walk_probe.burn(x, mode, steps=2048)
    assert torch.equal(got.cpu(), walk_probe.burn_plain(x.cpu(), steps=2048))
    st = stats.cpu()
    assert st.shape == (16, 3) and bool((st[:, 0] > 0).all())
    assert st[:, 1].tolist() == [2048] * 16
    assert st[:, 2].tolist() == ([0] * 16 if mode == "arbitrary"
                                 else list(range(16)))


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


#: chase's shapes on both sides of each cut of `chase_route`: the
#: global-memory body (8, 16, 262,144 words) and clusters of 8 CTAs (32,
#: the test shape 8,192, the probe's 65,536, 131,072)
CHASE_SHAPES = {8: (2, 4), 16: (4, 4), 32: (4, 8), 8192: (64, 128),
                65536: (512, 128), 131072: (1024, 128),
                262144: (2048, 128)}


def _chase_input(kind, r, c, seed=5):
    n = r * c
    rng = np.random.default_rng(seed)
    lo, hi = {"mixed": (-n, n), "negative": (-2**31, 0),
              "nonnegative": (0, 2 * n)}[kind]
    return rng.integers(lo, hi, (3, r, c)).astype(np.int32)


@pytest.mark.parametrize("rounds", [0, 1, 7, 8, 9])
@pytest.mark.parametrize("kind", ["mixed", "negative", "nonnegative"])
@pytest.mark.parametrize("n", list(CHASE_SHAPES))
def test_chase_routes_match_plain(cuda, n, kind, rounds):
    """chase on each body (the route the library reports is
    `chase_route`'s) equals the plain version bit for bit, on blocks of
    mixed, all-negative and all-nonnegative words (some past N - 1); stats
    hold each block's rounds and a positive cycle count."""
    r, c = CHASE_SHAPES[n]
    p = _chase_input(kind, r, c)
    got, stats = gather_probe.gather("chase", torch.from_numpy(p).to(cuda),
                                     steps=rounds)
    want, _ = gather_probe.gather("chase", p, steps=rounds, device="cpu")
    assert torch.equal(got.cpu(), want)
    st = stats.cpu()
    assert st[:, 1].tolist() == [rounds] * 3 and bool((st[:, 0] > 0).all())
    assert gather_probe.chase_plan(n)["cluster"] == gather_probe.chase_route(n)


@pytest.mark.parametrize("rounds", [0, 1, 8, 9])
@pytest.mark.parametrize("n", [32, 8192, 65536, 131072])
def test_chase_global_build_matches_plain(cuda, n, rounds):
    """The -DLZ4T_CHASE_GLOBAL build sends the shapes that the default
    build gives the cluster to the global-memory body; it equals the plain
    version bit for bit there too, stats holding each block's rounds."""
    r, c = CHASE_SHAPES[n]
    p = _chase_input("mixed", r, c)
    x = torch.from_numpy(p).to(cuda)
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    stats = torch.empty((3, 2), dtype=torch.int64, device=cuda)
    fn = _build.load(gather_probe.LIB, ("LZ4T_CHASE_GLOBAL",))
    rc = cm.launch(fn, cuda, x.data_ptr(), x.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), stats.data_ptr(), 3, r, c,
                   gather_probe.VARIANTS["chase"], rounds)
    cm.check_rc(rc, "probe_gather chase (global build)")
    want, _ = gather_probe.gather("chase", p, steps=rounds, device="cpu")
    assert torch.equal(out.cpu(), want)
    assert stats.cpu()[:, 1].tolist() == [rounds] * 3


def test_chase_plan_on_card(cuda):
    """Every cluster size chase launches can be resident (one cluster at
    least); the global-memory body reports none."""
    for n in CHASE_SHAPES:
        plan = gather_probe.chase_plan(n)
        k = gather_probe.chase_route(n)
        assert plan["cluster"] == k
        assert plan["chase_route"] == ("cluster" if k else "global")
        assert (plan["max_active_clusters"] > 0) == bool(k)


def test_chase_misaligned_views(cuda):
    """A view that starts 4 bytes past a 16-byte boundary: the wrapper
    copies it for the cluster body's bulk copies, and the C launcher
    refuses a misaligned output (cudaErrorMisalignedAddress) rather than
    run it."""
    p = _chase_input("mixed", 64, 128)
    flat = torch.from_numpy(p).to(cuda).reshape(-1)
    room = torch.empty(flat.numel() + 4, dtype=torch.int32, device=cuda)
    room[1:1 + flat.numel()] = flat
    view = room[1:1 + flat.numel()].view(3, 64, 128)
    got, _ = gather_probe.gather("chase", view)
    want, _ = gather_probe.gather("chase", p, device="cpu")
    assert torch.equal(got.cpu(), want)
    out = torch.empty(flat.numel() + 4, dtype=torch.int32, device=cuda)[1:]
    stats = torch.empty((3, 2), dtype=torch.int64, device=cuda)
    rc = cm.launch(_build.load(gather_probe.LIB), cuda, flat.data_ptr(),
                   flat.data_ptr(), out.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), 3, 64, 128, 3, 8)
    assert rc == 716


def test_chase_sass_loads(cuda):
    """C4: the global-memory body reads no buffer through the read-only
    path (no load with .CONSTANT anywhere in chase_kernel); the cluster
    body loads no global memory at all (its block arrives by bulk copy),
    and its round loop loads shared memory only."""
    ins = sass.library_sass(gather_probe.LIB, (), "chase_kernel")
    loads = sass.load_opcodes(ins)
    assert any(op.startswith("LDG") for op in loads)
    assert not any(".CONSTANT" in t for _, t, _ in ins), loads
    ins = sass.library_sass(gather_probe.LIB, (), "chase_cluster_kernel")
    loads = sass.load_opcodes(ins)
    assert loads and not any(op.startswith("LDG") for op in loads), loads
    assert any(lp["loads"] for lp in sass.loops(ins, 1))


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


def test_onehot_select_cycles_a_step(cuda):
    """The onehot body is one indexed load a step now, not 512 loads and
    multiplies: under 200 SM cycles a step at nit 4096 (nit / 4 steps)."""
    src, _ = lane_probe.inputs()["t_onehot"]
    got, stats = lane_probe.loop("onehot", torch.from_numpy(src).to(cuda),
                                 4096 // 4)
    want, _ = lane_probe.loop("onehot", src, 4096 // 4, device="cpu")
    assert torch.equal(got.cpu(), want)
    st = stats.cpu()
    assert bool((st[:, 0] / st[:, 1] < 200).all()), st.tolist()


def test_latency_build_chains(cuda):
    """Each chain of the latency build reports a positive latency an
    instruction, and the launch a positive clock; `latencies` raises
    where a chain's result differs from its host replay."""
    lat = walk_probe.latencies()
    assert set(lat["cycles"]) == set(walk_probe.cm.CLASSES)
    assert all(v > 0 for v in lat["cycles"].values()), lat
    assert lat["kernel_mhz"] > 0


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
