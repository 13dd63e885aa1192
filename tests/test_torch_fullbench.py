"""The port's per-stage micro-benchmark (`lz4_tpu_torch.probes.fullbench`,
the port of tools/fullbench.py): each primitive stage's torch ops against
the tool's `jnp` / `lax` stage on the same seeded operands, and the CLI's
stage lines on the CPU.

Tolerance: exact (integer results)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu_torch.probes import fullbench

B, NB = 2, 4096
N = NB + 272

#: every stage the tool prints (tools/fullbench.py:104-234) but
#: `sort_gather` and `dfloor_*`, plus the encoder's split
EXPECTED = (
    ["noop", "elementwise", "cumsum", "cummin_rev", "sort1", "sort2",
     "sort7", "gather_rand", "gather_u8", "scan_16k_u1", "scan_4k_u4",
     "scan_16k_2lane"]
    + [f"{s}_{c}" for c in ("text", "mixed", "rle")
       for s in ("encode", "etables", "ejump", "eparse", "eemit", "decode",
                 "dparse")]
    + ["encode_random", "decode_random", "encode_fast_text",
       "encode_fast_mixed"])


@pytest.fixture(scope="module")
def ops():
    arrays, _ = fullbench.operands(B, NB)
    return arrays


def _tool_scan_hops(p, steps, unroll):
    """tools/fullbench.py:129-144."""
    pe = p[:, : N - 8]

    def one(c, row):
        return jnp.take(row, jnp.clip(c + 3, 0, N - 9)), c

    def body(c, _):
        for _u in range(unroll):
            c, _o = jax.vmap(one)(c, pe)
        return c, None

    c, _ = jax.lax.scan(body, jnp.zeros(B, jnp.int32), None, length=steps)
    return c


def _tool_scan_hops2(p, steps):
    """tools/fullbench.py:152-162."""
    tab = jnp.stack([p[:, : N - 8], p[:, : N - 8] + 1], axis=-1)

    def body(c, _):
        g = jnp.take_along_axis(
            tab, jnp.clip(c[:, None, None] + 3, 0, N - 9), axis=1)
        return g[:, 0, 0] - g[:, 0, 1] + 1 + c, c

    c, _ = jax.lax.scan(body, jnp.zeros(B, jnp.int32), None, length=steps)
    return c


# (stage, the tool's jnp/lax function, the port's torch function, args);
# the scans at a reduced step count
CASES = {
    "noop": (lambda x: x[:1, :1] + 1, fullbench.noop, ("k32",)),
    "elementwise": (lambda x: (x ^ (x >> 3)) + 1, fullbench.elementwise,
                    ("k32",)),
    "cumsum": (lambda x: jnp.cumsum(x, axis=1), fullbench.cumsum, ("k32",)),
    "cummin_rev": (lambda x: jax.lax.cummin(x, axis=1, reverse=True),
                   fullbench.cummin_rev, ("k32",)),
    "sort1": (lambda k: jax.lax.sort((k,), num_keys=1),
              fullbench.sort_payloads, ("k32",)),
    "sort2": (lambda k, p: jax.lax.sort((k, p), num_keys=1),
              fullbench.sort_payloads, ("k32", "p1")),
    "sort7": (lambda k, p: jax.lax.sort(
        (k, p, p + 1, p + 2, p + 3, p + 4, p + 5), num_keys=1),
        fullbench.sort7, ("k32", "p1")),
    "gather_rand": (jax.vmap(jnp.take), fullbench.gather, ("p1", "gidx")),
    "gather_u8": (jax.vmap(jnp.take), fullbench.gather, ("u8", "gidx")),
    "scan_u1": (lambda p: _tool_scan_hops(p, 97, 1),
                lambda p: fullbench.scan_hops(p, 97, 1), ("p1",)),
    "scan_u4": (lambda p: _tool_scan_hops(p, 25, 4),
                lambda p: fullbench.scan_hops(p, 25, 4), ("p1",)),
    "scan_2lane": (lambda p: _tool_scan_hops2(p, 97),
                   lambda p: fullbench.scan_hops2(p, 97), ("p1",)),
}


@pytest.mark.parametrize("stage", list(CASES))
def test_primitive_matches_the_tool(ops, stage):
    tool_fn, port_fn, names = CASES[stage]
    want = jax.tree_util.tree_leaves(
        tool_fn(*(jnp.asarray(ops[n]) for n in names)))
    args = [torch.from_numpy(ops[n]) for n in names]
    if stage.startswith("gather"):
        args[1] = args[1].long()
    got = port_fn(*args)
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_scan_carry_moves(ops):
    """The hop chain is not stuck at 0: the carry after a few hops is a
    value of the row."""
    c = fullbench.scan_hops(torch.from_numpy(ops["p1"]), 3, 1)
    assert (c != 0).all()


def test_cli_prints_every_stage(capsys):
    assert fullbench.main(["--device", "cpu", "--b", str(B), "--block",
                           str(NB), "--seconds", "0"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[0])
    assert head["device"] == "cpu" and head["card"] is None
    rows = [json.loads(line) for line in lines[1:]]
    assert sorted(r["stage"] for r in rows) == sorted(EXPECTED)
    assert [r["stage"] for r in rows] == fullbench.stage_names()
    for r in rows:
        assert r["ms"] is None          # no device time on the CPU
        assert r["host_ms"] > 0 and r["runs"] >= 3
        if r["stage"] != "noop":
            assert "net_ms" in r


def test_cli_stage_filter_and_level_2(capsys):
    assert fullbench.main(["--device", "cpu", "--b", "2", "--block", "4096",
                           "--seconds", "0", "--level", "2", "--stages",
                           "encode_mixed,eemit_mixed,dparse_mixed"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()[1:]]
    assert [r["stage"] for r in rows] == ["encode_mixed", "eemit_mixed",
                                          "dparse_mixed"]
    assert all("MBs" in r for r in rows)


def test_encode_split_rebuilds_the_encoder():
    """The split's phases, run in order, give `encode_blocks`' bytes."""
    from lz4_tpu_torch.block import encode_sortscan
    from lz4_tpu_torch.utils.datagen import gen_buffer
    blob = gen_buffer(B * NB, match_prob=0.55, seed=12)
    src = torch.from_numpy(np.frombuffer(blob, np.uint8).reshape(B, NB)
                           .copy())
    lens = torch.full((B,), NB, dtype=torch.int32)
    for n_cand, lazy in fullbench.LEVELS.values():
        split = fullbench.EncodeSplit(src, lens, n_cand, lazy)
        (out, csize, _), = split.emit()
        ref, rsize, _ = encode_sortscan.encode_blocks(
            src, lens, cap_n=NB, has_dict=False, n_cand=n_cand, lazy=lazy)
        assert torch.equal(csize.int(), rsize)
        for i, n in enumerate(rsize.tolist()):
            assert torch.equal(out[i, :n], ref[i, :n])
        walk, = split.walk()
        assert torch.equal(walk, split.tokens[0])
