"""B1's lockstep scan on the CPU: `encode_cuda.encode_blocks_lockstep`
models, lane by lane, what the warp of `csrc/encode_serial.cu` does (32
probes a step, same-hash lanes resolved to the highest lower lane, the
first hit ends the scan, the lanes up to it commit with the highest of
each hash group writing, the previous match's tail insert folded into
the first window, and the history pre-insert as an atomic max).

Its streams are held equal to the plain version (`encode_blocks_plain`,
the serial parse) and, on small shapes, to the JAX package's Pallas
kernel in interpret mode. The blocks include ones built so that several
probes of one window share a hash slot (`gen_hash_walk`,
`gen_slot_words`: numpy searches of 4-byte sequences with equal 16-bit
Knuth hashes, from a seed). Tolerance: exact.

With a history the model also follows the dict solo path's window in
shared memory: it asserts on every read that none of the history lies
below the anchor's block index + 1 (what lets a history slot take a
block byte once the anchor passes it) and counts the block reads past
the served part of the window: a scan that reaches a probe pair within
the model's REACH of it leaves the window (`left`), and the kernel's
parse goes on from there with the row in shared memory and the history
in device memory.
"""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lz4_tpu.block.encode_pallas import encode_blocks_pallas  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch  # noqa: E402
from lz4_tpu_torch.block.encode_cuda import (  # noqa: E402
    LEAD, NEAR, REACH, SKIP_TRIGGER, STAGE_MIN, encode_blocks_lockstep,
    encode_blocks_plain, window_positions)
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_hash_walk,  # noqa: E402
                                         gen_slot_words, gen_text,
                                         knuth_hash16)


def _streams(out, csizes):
    return [out[i, :n].numpy().tobytes() for i, n in enumerate(csizes.tolist())]


def _model(blocks, prefixes=None, *, cap, jax_too=False, **kw):
    """The model's streams, held to the plain version (and to the JAX
    kernel in interpret mode when jax_too); returns the model."""
    arrays = pack_blocks(blocks, prefixes, cap=cap,
                         with_dict=prefixes is not None)
    t = to_device_batch(*arrays, device="cpu")
    po, pc, pt = encode_blocks_plain(*t, cap_n=cap, **kw)
    mo, mc, mt, model = encode_blocks_lockstep(*t, cap_n=cap, **kw)
    assert torch.equal(mc, pc) and torch.equal(mt, pt)
    assert _streams(mo, mc) == _streams(po, pc)
    if jax_too:
        src, lens, db, dl = arrays
        jo, jc, jt = (np.asarray(x) for x in encode_blocks_pallas(
            jnp.asarray(src), jnp.asarray(lens),
            None if db is None else jnp.asarray(db),
            None if dl is None else jnp.asarray(dl),
            cap_n=cap, interpret=True, **kw))
        np.testing.assert_array_equal(mc.numpy(), jc)
        np.testing.assert_array_equal(mt.numpy(), jt)
        assert _streams(mo, mc) == [jo[i, :n].tobytes()
                                    for i, n in enumerate(jc.tolist())]
    return model


def _collision_blocks(n, seed):
    return [gen_hash_walk(n, seed=seed), gen_slot_words(n, seed=seed),
            gen_slot_words(n // 3, pool=4, seed=seed + 1)]


def test_generators_share_slots():
    walk = np.frombuffer(gen_hash_walk(4096, slots=256, seed=3), np.uint8)
    w = walk.astype(np.uint64)
    seq = w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16) | (w[3:] << 24)
    slots, counts = np.unique(knuth_hash16(seq), return_counts=True)
    assert counts[np.argsort(counts)[-256:]].sum() > len(seq) // 2
    words = np.frombuffer(gen_slot_words(4096, pool=16, seed=4), "<u4")
    assert len(np.unique(knuth_hash16(words))) == 1
    assert len(np.unique(words)) == 16


@pytest.mark.parametrize("accel", [1, 4, 8, 65537])
def test_collision_blocks_vs_plain(accel):
    model = _model(_collision_blocks(8192, seed=accel), cap=8192,
                   acceleration=accel)
    if accel < 65537:
        assert model.shared > 0     # lanes of one window shared a slot


@pytest.mark.parametrize("accel", [1, 8])
def test_collision_blocks_vs_jax(accel):
    model = _model(_collision_blocks(3000, seed=10 + accel), cap=4096,
                   acceleration=accel, jax_too=True)
    assert model.shared > 0


def test_collision_dict_vs_jax():
    hist = gen_hash_walk(70000, seed=21)
    blocks = _collision_blocks(3000, seed=22)
    model = _model(blocks, [hist, hist[-2500:], None], cap=4096,
                   acceleration=4, jax_too=True)
    assert model.shared > 0


@pytest.mark.parametrize("accel", [1, 8, 65537])
def test_acceleration(accel):
    rng = np.random.default_rng(accel)
    blocks = [gen_text(20000, seed=accel), gen_buffer(20000, 0.7, seed=1),
              rng.bytes(5000)]
    model = _model(blocks, cap=20480, acceleration=accel)
    if accel < 65537:
        assert model.tails > 0      # a probe took the pending tail insert


def test_max_dist_2000():
    blocks = [gen_text(30000, seed=71),
              b"z" * 20000 + gen_text(10000, seed=72)]
    _model(blocks, cap=30000, max_dist=2000)
    _model(_collision_blocks(4000, seed=73), cap=4096, max_dist=2000,
           jax_too=True)


@pytest.mark.parametrize("stride", [1, 3, 7])
def test_dict_full_partial_and_empty_history(stride):
    rng = np.random.default_rng(stride)
    hist = gen_text(70000, seed=11)
    blocks = [gen_text(6000, seed=12), hist[-3000:] + rng.bytes(200),
              gen_buffer(5000, 0.6, seed=13), b"xyz", b""]
    prefixes = [hist, hist[-1000:], hist[-4000:], hist[-1:], None]
    _model(blocks, prefixes, cap=8192, dict_stride=stride,
           jax_too=stride == 3)


def test_short_blocks_around_mflimit():
    rng = np.random.default_rng(5)
    blocks = []
    for n in list(range(17)) + [13]:
        blocks += [gen_text(n, seed=n), b"\x00" * n, rng.bytes(n),
                   (b"ab" * 9)[:n]]
    _model(blocks, cap=32, jax_too=True)


def test_all_zero_and_random_blocks():
    rng = np.random.default_rng(6)
    _model([b"\x00" * 8192, rng.bytes(8192)], cap=8192, jax_too=True)
    model = _model([b"\x00" * 65536, rng.bytes(65536)], cap=65536)
    assert model.hits >= 1


@pytest.mark.parametrize("accel", [1, 2, 8, 1000, 65537])
def test_window_positions_are_the_serial_ones(accel):
    """The kernel's probe positions, a window of 32 at a time, are the
    serial loop's: it steps (srch >> 6) then ((srch + 1) >> 6) and adds 2
    to srch."""
    a = accel << SKIP_TRIGGER
    sp, srch, serial = 5, a, []
    while len(serial) < 640:
        sp1 = sp + (srch >> SKIP_TRIGGER)
        serial += [sp, sp1]
        sp = sp1 + ((srch + 1) >> SKIP_TRIGGER)
        srch += 2
    wp, lanes = 5, []
    for j0 in range(a, a + 640, 32):
        pos, wp = window_positions(wp, j0)
        lanes += pos
    assert lanes == serial


def _linked(make, n, seed):
    """(block, history): n bytes that go on from their 64 KB history, as
    the next block of a linked frame does."""
    data = make(65536 + n, seed)
    return data[65536:], data[:65536]


@pytest.mark.parametrize("accel", [1, 8, 65537])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("max_dist", [2000, 65535])
def test_window_reads_stay_above_the_anchor(max_dist, stride, accel):
    """Linked rows with a full, a partial and an empty history, each
    twice the lead: the model asserts on every read that the history
    below the anchor's block index + 1 is never read, while the window
    stages block bytes over it. At acceleration 65537 a window's probes
    span past the lead, so each block leaves the window at its first."""
    text, hist = _linked(lambda n, s: gen_text(n, seed=s), 16384, 31)
    mixed, mhist = _linked(lambda n, s: gen_buffer(n, 0.7, seed=s), 16384,
                           32)
    model = _model([text, mixed, gen_text(16384, seed=33)],
                   [hist, mhist[-3000:], None], cap=16384,
                   max_dist=max_dist, dict_stride=stride,
                   acceleration=accel)
    if accel == 65537:
        assert model.left == 3
    else:
        assert model.hist_reads > 0 and model.staged > 0
    if accel == 1:
        assert model.hist_sequences > 0 and model.left == 0


def test_window_offsets_at_the_history_edge():
    """A row equal to its random history (each probe's candidate lies
    65,536 back, out of reach, and its literals run past the lead) and a
    row equal to its history shifted by one byte (offset 65,535: the
    candidate is the history byte just above the anchor's block index,
    the lowest the window must still hold)."""
    rng = np.random.default_rng(34)
    hist = rng.bytes(65536)
    model = _model([hist, hist[1:] + b"x"], [hist, hist], cap=65536,
                   dict_stride=1)
    assert model.hist_sequences >= 1 and model.left > 0


def test_window_reads_past_the_lead():
    """Zero rows (one match runs the whole block, past the lead) and a
    random row (one literal run, past the lead: the anchor never moves,
    so nothing is staged). The forward count stages on as the match
    grows, so the window serves every read of the zero rows; the random
    row's probes reach the served part's end, so its parse leaves the
    window there."""
    rng = np.random.default_rng(35)
    for block, hist, far in [(bytes(65536), bytes(65536), False),
                             (bytes(65536), None, False),
                             (rng.bytes(65536), rng.bytes(65536), True)]:
        model = _model([block], [hist], cap=65536)
        assert model.left == far and model.block_reads > 0
        assert model.staged == (0 if far else 65536 - LEAD)


def test_window_serves_the_cell_rows():
    """Four rows of the lz4f-linked-64k.compress cell's corpus (one of
    each class, made on the CPU from the cell's generator at seed
    2650000017 in strata of 8): the window serves every read, so no
    block leaves it, and a share of the windows and matches reach into
    the history."""
    from benchmark import corpus
    spec = dict(corpus.load_spec("silesia-like"), stratum_blocks=8)
    data, classes = corpus.make_corpus(spec, 2650000017, 8, 131072, "cpu")
    rows = [int(torch.nonzero(classes == c)[0]) for c in range(4)]
    host = data[rows].numpy()
    model = _model([r[65536:].tobytes() for r in host],
                   [r[:65536].tobytes() for r in host], cap=65536)
    assert model.left == 0
    assert model.staged == 4 * (65536 - LEAD)
    assert model.hist_windows > model.windows // 4
    assert model.hist_sequences > model.hits // 20


@pytest.mark.parametrize("name,kernel", [("LEAD", "kLead"),
                                         ("NEAR", "kNear"),
                                         ("STAGE_MIN", "kStageMin"),
                                         ("REACH", "kReach")])
def test_window_constants_are_the_kernels(name, kernel):
    """The model's staging constants are the kernel's, as its source
    (`csrc/encode_serial.cu`) defines them."""
    cu = (Path(__file__).parents[1] / "lz4_tpu_torch" / "csrc" /
          "encode_serial.cu").read_text()
    exprs = dict(re.findall(r"constexpr int (k\w+) = ([\w +*/]+);", cu))

    def value(k):
        expr = re.sub(r"k\w+", lambda m: str(value(m.group())), exprs[k])
        return eval(expr.replace("/", "//"))

    assert value(kernel) == {"LEAD": LEAD, "NEAR": NEAR,
                             "STAGE_MIN": STAGE_MIN, "REACH": REACH}[name]
