"""The host worker pool: `HostBackend(nb_workers)` and
`default_nb_workers` against `lz4_tpu.block.backend`'s, the CLI's -T#,
--threads= and LZ4_NBWORKERS reaching the backend in both packages, and
`TorchBackend`'s one cached host tier. Tolerance: exact (bytes, and the
worker counts)."""
import pytest

pytest.importorskip("jax")

import lz4_tpu.block.backend as jbackend  # noqa: E402
import lz4_tpu.cli as jcli  # noqa: E402
from lz4_tpu_torch import cli  # noqa: E402
from lz4_tpu_torch.block import backend  # noqa: E402
from lz4_tpu_torch.block.backend import (BlockDecodeError,  # noqa: E402
                                         HostBackend, default_nb_workers)
from lz4_tpu_torch.native import blockcodec  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

HIST = gen_text(70000, seed=7)
BLOCKS = [gen_text(9000 + 500 * i, seed=i) if i % 2 else
          gen_buffer(7000 + 300 * i, 0.7, seed=i) for i in range(7)]
PREFIXES = [HIST[-(2000 * i + 1):] if i % 3 else None for i in range(7)]

COMPRESS = {
    "batch": {},
    "one_block": {"blocks": BLOCKS[:1]},
    "dict": {"dict_prefixes": PREFIXES},
    "accel": {"acceleration": 8},
    "max_dist": {"max_dist": 2048},
    "max_dist_dict": {"max_dist": 4096, "dict_prefixes": PREFIXES},
    "hc3": {"level": 3},
    "hc9_dict": {"level": 9, "dict_prefixes": PREFIXES},
    "hc12": {"level": 12},
    "favor": {"level": 9, "favor_dec_speed": True},
}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("route", list(COMPRESS))
def test_compress_routes_match_reference(route, workers):
    kw = dict(COMPRESS[route])
    blocks = kw.pop("blocks", BLOCKS)
    ours = HostBackend(nb_workers=workers).compress_batch(blocks, **kw)
    assert ours == jbackend.HostBackend(nb_workers=4).compress_batch(
        blocks, **kw)
    prefixes = kw.get("dict_prefixes")
    assert HostBackend(nb_workers=workers).decompress_batch(
        ours, [len(b) for b in blocks], dict_prefixes=prefixes) == blocks


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("route", ["batch", "one_block", "dict"])
def test_decompress_routes_match_reference(route, workers):
    blocks = BLOCKS[:1] if route == "one_block" else BLOCKS
    prefixes = PREFIXES if route == "dict" else None
    comp = [blockcodec.compress(b, dict_prefix=d)
            for b, d in zip(blocks, prefixes or [None] * len(blocks))]
    caps = [len(b) + 100 for b in blocks]
    ours = HostBackend(nb_workers=workers).decompress_batch(
        comp, caps, dict_prefixes=prefixes)
    assert ours == blocks == jbackend.HostBackend(
        nb_workers=4).decompress_batch(comp, caps, dict_prefixes=prefixes)
    bad = list(comp)
    bad[-1] = bad[-1][: len(bad[-1]) // 2]
    with pytest.raises(BlockDecodeError):
        HostBackend(nb_workers=workers).decompress_batch(
            bad, caps, dict_prefixes=prefixes)


def test_batch_calls_split_over_the_pool(monkeypatch):
    """Four workers: one batch C call per contiguous range of blocks."""
    be = HostBackend(nb_workers=4)
    calls = []
    orig = type(be._native).compress_batch

    def spy(self, bs, acceleration=1):
        calls.append(len(bs))
        return orig(self, bs, acceleration=acceleration)
    monkeypatch.setattr(type(be._native), "compress_batch", spy)
    assert be.compress_batch(BLOCKS) == HostBackend().compress_batch(BLOCKS)
    assert sorted(calls[:4]) == [1, 2, 2, 2] and calls[4:] == [7]
    assert be._pool is not None


@pytest.mark.parametrize("env", [None, "3", "0", "x"])
def test_default_nb_workers_matches_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("LZ4_NBWORKERS", raising=False)
    else:
        monkeypatch.setenv("LZ4_NBWORKERS", env)
    assert default_nb_workers() == jbackend.default_nb_workers() >= 1


@pytest.mark.parametrize("flags,env,want", [
    ([], None, "auto"), (["-T3"], None, 3), (["-T0"], None, "auto"),
    (["-T1"], "5", 1), (["--threads=6"], None, 6), ([], "2", 2),
    ([], "0", 0)])
def test_cli_worker_count_reaches_the_backend(monkeypatch, tmp_path, flags,
                                              env, want):
    """Both CLIs hand the same count to their HostBackend."""
    if env is None:
        monkeypatch.delenv("LZ4_NBWORKERS", raising=False)
    else:
        monkeypatch.setenv("LZ4_NBWORKERS", env)
    seen = {}
    for name, mod in (("ours", backend), ("ref", jbackend)):
        orig = mod.HostBackend.__init__

        def init(self, nb_workers=0, _orig=orig, _name=name):
            seen[_name] = nb_workers
            _orig(self, nb_workers)
        monkeypatch.setattr(mod.HostBackend, "__init__", init)
    src = tmp_path / "in.bin"
    src.write_bytes(gen_text(20000, seed=1))
    assert cli.main(["lz4", "-f", "-q", *flags, "--backend", "host",
                     str(src), str(tmp_path / "a.lz4")]) == 0
    assert jcli.main(["lz4", "-f", "-q", *flags, "--backend", "host",
                      str(src), str(tmp_path / "b.lz4")]) == 0
    assert seen["ours"] == seen["ref"] == (
        default_nb_workers() if want == "auto" else want)
    assert (tmp_path / "a.lz4").read_bytes() == \
        (tmp_path / "b.lz4").read_bytes()


def test_torch_backend_keeps_one_host_tier(monkeypatch):
    be = TorchBackend("cpu", nb_workers=3)
    host = be._host()
    assert host is be._host() and host.nb_workers == 3
    calls = []
    orig = HostBackend.compress_batch

    def spy(self, *a, **k):
        calls.append(self)
        return orig(self, *a, **k)
    monkeypatch.setattr(HostBackend, "compress_batch", spy)
    out = be.compress_batch(BLOCKS[:3], level=12)
    assert calls == [host]
    assert out == HostBackend().compress_batch(BLOCKS[:3], level=12)
