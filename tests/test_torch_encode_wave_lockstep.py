"""B4's warp on the CPU: `encode_wave.find_matches_lockstep` models, lane
by lane, what the warp of `csrc/encode_wave.cu` does (32 positions a
step: peer groups of equal hash among the inserting lanes, the table
write-back by the highest lane of each group, the linked warmup the same
way, each startable lane's agreement to the step's end, and the start /
end machine over those agreements, a match carried into the next step
verified there by a ballot over byte compares).

Its decisions are held equal to the plain version (`find_matches_plain`,
the serial scan) and to the JAX package's `_encode_wave_kernel` in
interpret mode, no-dict and linked, at hash_bits 9, 10 and 15, max_dist
2048 and 65534, with runs longer than 16 KB (the force-end) and lengths
of every residue mod 4. Tolerance: exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lz4_tpu.block import encode_wave as jew  # noqa: E402
from lz4_tpu_torch.block import encode_wave as tew  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402


def _blocks(size, seed):
    """Blocks of at most `size` bytes: text, a byte pool of 4 values (many
    equal hashes in one step, stale table entries), zeros, random bytes,
    short rows, and lengths of every residue mod 4."""
    rng = np.random.default_rng(seed)
    return [gen_text(size - 3, seed=seed),
            bytes(rng.integers(0, 4, size - 2, dtype=np.uint8)),
            b"\x00" * (size - 1), rng.bytes(size // 2 + 1),
            gen_buffer(size, 0.8, seed=seed + 1), b"Q", b"", b"abc" * 4,
            (b"0123456789abcdef" * (size // 16))[: size - 5]]


def _packed(blocks):
    n_rows = tew.rows_for(max(len(b) for b in blocks))
    inp, lens = tew.pack_input(blocks, n_rows)
    return n_rows, inp, lens


def _hold(inp, lens, hist=None, hlen=None, **kw):
    """Model == plain; returns the decisions and the models."""
    t = [torch.from_numpy(a) for a in (inp, lens)]
    if hist is not None:
        t += [torch.from_numpy(hist), torch.from_numpy(hlen)]
    plain = tew.find_matches_plain(*t, **kw)
    model, models = tew.find_matches_lockstep(*t, **kw)
    assert torch.equal(model, plain)
    return model.numpy(), models


@pytest.mark.parametrize("hash_bits,max_dist,size",
                         [(9, 2048, 16384), (10, 2048, 16384),
                          (10, 65534, 16384), (15, 65534, 4096),
                          (15, 2048, 4096)])
def test_model_vs_plain_and_jax(hash_bits, max_dist, size):
    blocks = _blocks(size, seed=hash_bits)
    n_rows, inp, lens = _packed(blocks)
    ours, models = _hold(inp, lens, max_dist=max_dist, hash_bits=hash_bits)
    want = np.asarray(jew.find_matches_batch(
        blocks, interpret=True, max_dist=max_dist,
        hash_bits=hash_bits)).T[: len(blocks)]
    np.testing.assert_array_equal(ours, want)
    assert (ours != 0).sum() > 100
    # the machine ran more than one round in some steps, and matches
    # crossed steps
    assert sum(m.rounds for m in models) > 2 * sum(m.steps for m in models)


@pytest.mark.parametrize("max_dist", [2048, 65534])
def test_runs_longer_than_16k(max_dist):
    """The force-end at mlen 16387 inside one run, with a period-1 and a
    period-3 run, lengths 40000-40003 (every residue mod 4)."""
    blocks = [b"\x00" * 40000, b"abc" * 13334, b"\x07" * 40002,
              gen_text(3000, seed=3) + b"z" * 37001]
    _, inp, lens = _packed(blocks)
    ours, _ = _hold(inp, lens, max_dist=max_dist, hash_bits=10)
    mlens = (ours.view(np.uint32) >> 18) + 4
    assert mlens.max() == 16387         # ends at mlen 16384 + 3
    want = np.asarray(jew.find_matches_batch(
        blocks, interpret=True, max_dist=max_dist,
        hash_bits=10)).T[: len(blocks)]
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("hash_bits,max_dist",
                         [(9, 2048), (10, 65534), (15, 2048)])
def test_linked_model_vs_plain_and_jax(hash_bits, max_dist):
    """Linked rows: full, partial and empty history, its warmup 32
    positions a step, mod-2^16 distances and the 0xFFFF sentinel."""
    rng = np.random.default_rng(hash_bits)
    blocks = _blocks(4096, seed=20 + hash_bits)
    n_rows, inp, lens = _packed(blocks)
    wr = tew.history_rows(max_dist, n_rows)
    text = np.frombuffer(gen_text(70000, seed=5), np.uint8)
    hist = np.tile(text[-wr * 4:], (len(blocks), 1))
    hist[1] = rng.integers(0, 4, wr * 4, dtype=np.uint8)
    hlen = np.array([wr * 4, wr * 4, 300, 0, 7, wr * 4, 1, 100, 4093],
                    np.int32)
    ours, _ = _hold(inp, lens, hist, hlen, max_dist=max_dist,
                    hash_bits=hash_bits)
    # the JAX kernel's layout: (rows, 128) little-endian words
    jinp, jlens = jew.pack_input(blocks, n_rows)
    hb = np.zeros((128, wr * 4), np.uint8)
    hb[: len(blocks)] = hist
    hw = hb.reshape(128, wr, 4).astype(np.int32)
    jhist = np.ascontiguousarray((hw[..., 0] | (hw[..., 1] << 8)
                                  | (hw[..., 2] << 16) | (hw[..., 3] << 24)).T)
    jhlen = np.zeros((1, 128), np.int32)
    jhlen[0, : len(blocks)] = hlen
    want = np.asarray(jew._encode_wave_linked_raw(
        jinp, jlens, jhist, jhlen, n_rows=n_rows, interpret=True,
        use_onehot=False, max_dist=max_dist,
        hash_bits=hash_bits)).T[: len(blocks)]
    np.testing.assert_array_equal(ours, want)
    # some matches reach into the history
    offs = ours & 0xFFFF
    ends = 4 * np.arange(n_rows)[None, :] + ((ours >> 16) & 3)
    mlen = (ours.view(np.uint32) >> 18) + 4
    assert ((ours != 0) & (ends - mlen - offs < 0)).any()


def test_insert_step_is_the_serial_order():
    """One step of 32 inserts with repeated hashes leaves the table and
    the entries each lane sees exactly as 32 serial inserts do."""
    rng = np.random.default_rng(7)
    for _ in range(50):
        m = tew.WaveLockstepModel(np.zeros(4, np.uint8), 0, None, 0, 2048, 3)
        m.table = [int(v) for v in rng.integers(0, 1 << 32, 8,
                                                dtype=np.uint64)]
        serial = list(m.table)
        hs = [int(h) for h in rng.integers(0, 8, 32)]
        pos = [int(p) for p in rng.integers(0, 1 << 16, 32)]
        k = int(rng.integers(0, 33))
        ins = [i < k for i in range(32)]
        seen = m.insert_step(hs, pos, ins)
        for i in range(32):
            assert seen[i] == serial[hs[i]]
            if ins[i]:
                serial[hs[i]] = ((serial[hs[i]] << 16) | pos[i]) & 0xFFFFFFFF
        assert m.table == serial
