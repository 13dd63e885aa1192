"""The sort/scan encoder as torch ops (`lz4_tpu_torch.block.encode_sortscan`)
against the JAX package's `lz4_tpu.block.encode_jax.encode_blocks` on the
CPU, on the same seeded numpy inputs: the fast graph, the level-2 graph
(8 candidates, lazy) and the lite graph, without and with history; the
two hop parses; and level 2 through both CLIs. Tolerance: exact (out,
csizes and trailing).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lz4_tpu import cli as jcli  # noqa: E402
from lz4_tpu.block import encode_jax  # noqa: E402
from lz4_tpu_torch import cli  # noqa: E402
from lz4_tpu_torch.block import encode_sortscan  # noqa: E402
from lz4_tpu_torch.block.batch import pack_blocks  # noqa: E402
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

GRAPHS = [(2, False, False), (8, True, False), (2, False, True)]


def _rows(cap, seed):
    rng = np.random.default_rng(seed)
    t = gen_text(cap, seed=seed)
    return [t, gen_buffer(cap, 0.7, seed=seed + 1), bytes(cap),
            b"abc" * 4, bytes(12), rng.bytes(cap * 3 // 4),
            # a match whose back-extension reaches the buffer start
            (b"\x00\x00" + b"d\n        return" * (cap // 16))[:cap],
            b"ab" * (cap // 2)]


def _arrays(blocks, cap, hist_lens, seed):
    hist = gen_text(70000, seed=seed + 7)
    prefixes = [hist[len(hist) - k:] if k else None for k in hist_lens]
    src, lens, db, dl = pack_blocks(blocks, prefixes, cap=cap,
                                    with_dict=True)
    return src, lens, db, dl


def _both(arrays, **kw):
    want = [np.asarray(x) for x in encode_jax.encode_blocks(
        *(jnp.asarray(a) for a in arrays), **kw)]
    got = encode_sortscan.encode_blocks(
        *(torch.from_numpy(a) for a in arrays), **kw)
    return want, [x.numpy() for x in got]


@pytest.mark.parametrize("has_dict", [False, True], ids=["nodict", "dict"])
@pytest.mark.parametrize("graph", GRAPHS,
                         ids=["fast", "level2", "lite"])
def test_encode_blocks_vs_jax(graph, has_dict):
    n_cand, lazy, lite = graph
    cap = 2048
    blocks = _rows(cap, seed=3)
    arrays = _arrays(blocks, cap,
                     [65536, 3000, 0, 100, 5, 65536, 0, 40000], seed=3)
    want, got = _both(arrays, cap_n=cap, has_dict=has_dict, n_cand=n_cand,
                      lazy=lazy, lite=lite)
    for w, g, name in zip(want, got, ("out", "csizes", "trailing")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32
    assert got[0].shape == (len(blocks), cap + cap // 255 + 16)
    # every stream decodes to its block
    _, _, db, dl = arrays
    for i, b in enumerate(blocks):
        pre = db[i, 65536 - dl[i]:].tobytes() if has_dict else None
        assert blockcodec.decompress(got[0][i, : got[1][i]].tobytes(),
                                     len(b), dict_prefix=pre or None) == b


@pytest.mark.parametrize("cap", [1024, 4096])
def test_level2_graph_other_widths(cap):
    blocks = _rows(cap, seed=cap)[:4] + [gen_text(cap - 3, seed=9)]
    arrays = _arrays(blocks, cap, [0] * len(blocks), seed=cap)
    want, got = _both(arrays, cap_n=cap, has_dict=False, n_cand=8,
                      lazy=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_hop_parses_agree():
    """Pointer doubling and the hop loop (the JAX module's walk) give the
    same tokens."""
    cap = 4096
    blocks = _rows(cap, seed=5)
    src, lens, db, dl = (torch.from_numpy(a) for a in _arrays(
        blocks, cap, [0] * len(blocks), seed=5))
    tabs = encode_sortscan._match_tables(
        src.long(), lens.long(), torch.zeros_like(lens.long()), d0=0,
        n_cand=8, lazy=True, lite=False)
    a = encode_sortscan._parse_hops(tabs[0], tabs[1], d0=0, cap_n=cap)
    b = encode_sortscan._parse_hops_loop(tabs[0], tabs[1], d0=0, cap_n=cap)
    assert torch.equal(a, b)
    assert int((a < cap).sum()) > 100


def test_chunks_of_rows_give_the_same_bytes(monkeypatch):
    cap = 1024
    blocks = _rows(cap, seed=8)
    src, lens, _, _ = (torch.from_numpy(a) for a in _arrays(
        blocks, cap, [0] * len(blocks), seed=8))
    kw = dict(cap_n=cap, has_dict=False, n_cand=8, lazy=True)
    whole = encode_sortscan.encode_blocks(src, lens, **kw)
    monkeypatch.setitem(encode_sortscan.BUDGET, "cpu", 1)   # one row each
    assert encode_sortscan.chunk_rows(cap, src.device) == 1
    rows = encode_sortscan.encode_blocks(src, lens, **kw)
    assert all(torch.equal(p, q) for p, q in zip(whole, rows))


def test_encode_blocks_checks_its_arguments():
    src = torch.zeros((2, 131072), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        encode_sortscan.encode_blocks(src, lens, cap_n=131072,
                                      has_dict=False)
    with pytest.raises(ValueError, match="uint8"):
        encode_sortscan.encode_blocks(src[:, :1000].contiguous(), lens,
                                      cap_n=1024, has_dict=False)
    with pytest.raises(ValueError, match="has_dict"):
        encode_sortscan.encode_blocks(src[:, :1024].contiguous(), lens,
                                      cap_n=1024, has_dict=True)
    empty = encode_sortscan.encode_blocks(
        torch.zeros((0, 1024), dtype=torch.uint8),
        torch.zeros(0, dtype=torch.int32), cap_n=1024, has_dict=False)
    assert [tuple(t.shape) for t in empty] == [(0, 1044), (0,), (0,)]


def test_cli_level2_writes_the_jax_cli_frame(tmp_path, monkeypatch):
    """`lz4_tpu_torch.cli -2` (on TorchBackend, here on the CPU) and
    `lz4_tpu.cli -2` (TpuBackend) write the same frame."""
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    # keep the JAX CLI's persistent compile cache out of this run
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    port = TorchBackend("cpu")
    monkeypatch.setattr(cli, "_select_backend",
                        lambda name, nb_workers=0: port)
    src = tmp_path / "data.bin"
    src.write_bytes(gen_text(20000, seed=41) + gen_buffer(9000, 0.8,
                                                          seed=42))
    ours, theirs = tmp_path / "ours.lz4", tmp_path / "theirs.lz4"
    assert cli.main(["lz4-torch", "-2", "-f", str(src), str(ours)]) == 0
    assert port.device_hc_encoded == 1
    assert jcli.main(["lz4-tpu", "--backend", "tpu", "-2", "-f", str(src),
                      str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    out = tmp_path / "out.bin"
    assert cli.main(["lz4-torch", "-d", "-f", str(ours), str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()
