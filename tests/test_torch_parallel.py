"""The multi-GPU engine on torch.distributed against the JAX mesh engine.

`python -m lz4_tpu_torch.parallel.dryrun --spawn 2 --device cpu` runs two
gloo processes (one rank each, joined by a file store) through
`dryrun_multichip` at 4 KB blocks and saves rank 0's results; the same
inputs go through `lz4_tpu.parallel.engine` on a 2-device CPU mesh:
`linked_encode_step`, `ShardedCodec.decode` (with its error path) and
`.encode`, `TpuBackend(ShardedCodec)` at level 1 (its Pallas kernels in
interpret mode) and `wave_encode_sharded`. In process, a world-size-1
gloo group drives `TorchBackend(codec=...)` on every route against
`TorchBackend("cpu")`. Tolerance: exact (bytes, sizes and flags).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa

from lz4_tpu.parallel import engine as jengine  # noqa: E402
from lz4_tpu.utils.datagen import gen_buffer as jgen_buffer  # noqa: E402
from lz4_tpu_torch.block.backend import (BlockDecodeError,  # noqa: E402
                                         HostBackend)
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel.engine import (ShardedCodec,  # noqa: E402
                                           TorchBackend,
                                           linked_encode_step)
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

CAP = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(rank 0's results, the printed line) of a 2-process gloo run."""
    out = str(tmp_path_factory.mktemp("dryrun") / "rank0.npz")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "lz4_tpu_torch.parallel.dryrun", "--spawn",
         "2", "--device", "cpu", "--cap", str(CAP), "--out", out,
         "--timeout", "100"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out)), proc.stdout.strip()


@pytest.fixture(scope="module")
def mesh2():
    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def test_dryrun_spawn_prints_verified(spawned):
    _, line = spawned
    assert line.startswith("dryrun_multichip(2): linked encode 2x4096B")
    assert line.endswith("verified")


def test_linked_encode_step_matches_jax(spawned, mesh2):
    r, _ = spawned
    src = r["src"]
    assert src.tobytes() == jgen_buffer(2 * CAP, match_prob=0.7, seed=3)
    shard = NamedSharding(mesh2, P("data"))
    repl = NamedSharding(mesh2, P())
    want = [np.asarray(x) for x in jengine.linked_encode_step(
        jax.device_put(src, shard),
        jax.device_put(np.full(2, CAP, np.int32), shard),
        jax.device_put(np.zeros((1, 65536), np.uint8), repl),
        jax.device_put(np.zeros(1, np.int32), repl), cap_n=CAP,
        mesh=mesh2)]
    for name, w in zip(("comp", "csizes", "offsets"), want):
        np.testing.assert_array_equal(r[name], w)
    assert int(r["total"]) == int(want[3][0])


def test_sharded_decode_and_error_path_match_jax(spawned, mesh2):
    r, _ = spawned
    src, comp, csizes = r["src"], r["comp"], r["csizes"]
    cap_in = CAP + CAP // 255 + 32
    comp_in = np.zeros((2, cap_in), np.uint8)
    for i in range(2):
        comp_in[i, : csizes[i]] = comp[i, : csizes[i]]
    dbufs = np.zeros((2, 65536), np.uint8)
    dbufs[1, 65536 - CAP:] = src[0]
    dlens = np.asarray([0, CAP], np.int32)
    codec = jengine.ShardedCodec(mesh2)
    out, olen, err = (np.asarray(x) for x in codec.decode(
        comp_in, csizes, dbufs, dlens, cap_out=CAP, has_dict=True))
    np.testing.assert_array_equal(r["dout"], out)
    np.testing.assert_array_equal(r["dlen"], olen)
    np.testing.assert_array_equal(r["derr"], err)
    bad = comp_in.copy()
    bad[1, 4:10] = 0xFF
    bad_lens = csizes.copy()
    bad_lens[1] = min(int(bad_lens[1]), 24)
    errs = np.asarray(codec.decode(bad, bad_lens, dbufs, dlens, cap_out=CAP,
                                   has_dict=True)[2])
    np.testing.assert_array_equal(r["errs_bad"], errs)
    assert errs.tolist() == [0, 1]


def test_sharded_encode_matches_jax(spawned, mesh2):
    r, _ = spawned
    codec = jengine.ShardedCodec(mesh2)
    out, csizes, _ = (np.asarray(x) for x in codec.encode(
        r["src"], np.full(2, CAP, np.int32), np.zeros((2, 65536), np.uint8),
        np.zeros(2, np.int32), cap_n=CAP, has_dict=False, n_cand=2))
    np.testing.assert_array_equal(r["eout"], out)
    np.testing.assert_array_equal(r["esize"], csizes)


def test_sharded_backend_matches_tpu_backend(spawned, mesh2, monkeypatch):
    """TorchBackend(codec=...) runs B1 on each rank's shard, as
    TpuBackend(ShardedCodec) runs the Pallas kernel under shard_map."""
    monkeypatch.setenv("LZ4_TPU_PALLAS_CPU", "1")
    r, _ = spawned
    blocks = [gen_buffer(4096, match_prob=0.6, seed=100 + i)
              for i in range(2)]
    want = jengine.TpuBackend(jengine.ShardedCodec(mesh2)).compress_batch(
        blocks, level=1)
    sizes = r["pcomp_sizes"].tolist()
    assert sizes == [len(w) for w in want]
    assert r["pcomp"].tobytes() == b"".join(want)


def test_wave_encode_sharded_matches_jax(spawned, mesh2):
    from lz4_tpu.block.encode_wave import pack_input
    r, _ = spawned
    blocks = [gen_buffer(4096, match_prob=0.7, seed=200 + i)
              for i in range(2)]
    inp = np.zeros((2, 1024 + 8, 128), np.int32)
    lens = np.zeros((2, 1, 128), np.int32)
    for i, b in enumerate(blocks):
        inp[i], lens[i] = pack_input([b], 1024)
    shard = NamedSharding(mesh2, P("data"))
    dec = np.asarray(jengine.wave_encode_sharded(
        jax.device_put(inp, shard), jax.device_put(lens, shard),
        n_rows=1024, interpret=True, use_onehot=False, max_dist=2048,
        hash_bits=9, mesh=mesh2))
    np.testing.assert_array_equal(r["wdec"], dec[:, :, 0])


@pytest.fixture
def group1(tmp_path):
    """A world-size-1 gloo group on a file store (no TCP port)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_codec_needs_a_group():
    with pytest.raises(RuntimeError):
        ShardedCodec(device="cpu")


ROUTES = ["level1", "level1_dict", "level2", "level1_big", "hc3",
          "max_dist", "sortscan", "decode_b2", "decode_dict"]


@pytest.mark.parametrize("route", ROUTES)
def test_torch_backend_under_codec(group1, route):
    """Every route under a world-size-1 codec gives TorchBackend("cpu")'s
    bytes; HC levels 3-9 and max_dist go to the host tier, as in
    TpuBackend(codec)."""
    be = TorchBackend(codec=ShardedCodec(device="cpu"))
    one = TorchBackend("cpu")
    hist = gen_text(70000, seed=5)
    blocks = [gen_text(5000 + 300 * i, seed=i) for i in range(3)]
    prefixes = None
    kw = {"level": 1}
    if route == "level1_dict":
        prefixes = [hist[-(1000 * (i + 1)):] for i in range(3)]
    elif route == "level2":
        kw = {"level": 2}
    elif route == "level1_big":
        blocks = [gen_buffer(70000, 0.8, seed=9)]
    elif route == "hc3":
        kw = {"level": 3}
    elif route == "max_dist":
        kw = {"level": 1, "max_dist": 2048}
    elif route == "sortscan":
        be.serial_encode = one.serial_encode = False
        be.serial_decode = one.serial_decode = False
    elif route == "decode_dict":
        prefixes = [hist, None, hist[-3000:]]
    comp = be.compress_batch(blocks, dict_prefixes=prefixes, **kw)
    if route in ("hc3", "max_dist"):
        assert comp == HostBackend().compress_batch(blocks, **kw)
        assert be.hc_encoded == be.wave_encoded == 0
    else:
        assert comp == one.compress_batch(blocks, dict_prefixes=prefixes,
                                          **kw)
    be.wave_decode = one.wave_decode = False
    mo = [len(b) for b in blocks]
    back = be.decompress_batch(comp, mo, dict_prefixes=prefixes)
    assert back == one.decompress_batch(comp, mo, dict_prefixes=prefixes)
    assert back == blocks
    if route == "sortscan":
        assert be.sortscan_decoded == 1
        comp[1] = comp[1][: len(comp[1]) // 2]
        with pytest.raises(BlockDecodeError):
            be.decompress_batch(comp, mo)


def test_linked_encode_step_world1(group1):
    """One rank: the first block takes head_dict, and offsets are the
    exclusive prefix sum."""
    src = np.frombuffer(gen_buffer(3 * CAP, 0.7, seed=3),
                        np.uint8).reshape(3, CAP).copy()
    lens = np.asarray([CAP, 1000, CAP], np.int32)
    head = np.zeros((1, 65536), np.uint8)
    head[0, -CAP:] = src[2]
    comp, csizes, offsets, total = (t.numpy() for t in linked_encode_step(
        src, lens, head, np.asarray([CAP], np.int32), cap_n=CAP,
        device="cpu"))
    assert offsets.tolist() == [0, csizes[0], csizes[0] + csizes[1]]
    assert int(total[0]) == csizes.sum()
    prev = [src[2], src[0], src[1, :1000]]
    for i in range(3):
        dec = blockcodec.decompress(comp[i, : csizes[i]].tobytes(),
                                    int(lens[i]),
                                    dict_prefix=prev[i].tobytes())
        assert dec == src[i, : lens[i]].tobytes()


def test_entry_matches_jax_encoder():
    """dryrun.entry(): the sort/scan encode step on its example batch,
    equal to `encode_jax.encode_blocks` on the same arrays."""
    from lz4_tpu.block.encode_jax import encode_blocks
    from lz4_tpu_torch.parallel.dryrun import entry
    fn, args = entry("cpu")
    got = fn(*args)
    want = encode_blocks(*(a.numpy() for a in args), cap_n=4096,
                         has_dict=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out, csizes = got[0].numpy(), got[1].tolist()
    assert [blockcodec.decompress(out[i, : csizes[i]].tobytes(), 4096)
            for i in range(4)] == [r.tobytes() for r in args[0].numpy()]
