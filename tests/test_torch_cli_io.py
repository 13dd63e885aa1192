"""The port's CLI (`lz4_tpu_torch.cli`), file I/O engine
(`lz4_tpu_torch.io.engine`), `-b` harness and file objects, black-box and
against the JAX package's: files written by either CLI decode through
the other, and with the same flags on the host tier both write the same
bytes. The GPU backend is reached here as `TorchBackend("cpu")` through
`io.engine`'s `backend=` argument.
"""
import os
import struct

import pytest
import torch

jax = pytest.importorskip("jax")

from lz4_tpu import cli as jcli  # noqa: E402
from lz4_tpu.block.backend import HostBackend as JaxHost  # noqa: E402
from lz4_tpu.frame import reader as jreader  # noqa: E402
from lz4_tpu.io import engine as jio  # noqa: E402
from lz4_tpu_torch import cli  # noqa: E402
from lz4_tpu_torch.frame.file import open_frame  # noqa: E402
from lz4_tpu_torch.frame.format import parse_frame_header  # noqa: E402
from lz4_tpu_torch.frame.writer import (compress_frame,  # noqa: E402
                                        write_skippable_frame)
from lz4_tpu_torch.io.engine import (IoPrefs, SparseWriter,  # noqa: E402
                                     compress_file, decompress_file,
                                     format_list_output, list_frames)
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import (gen_buffer, gen_text,  # noqa: E402
                                         mixed_corpus)


@pytest.fixture
def corpus(tmp_path):
    p = tmp_path / "data.bin"
    p.write_bytes(gen_text(90000, seed=77) + mixed_corpus(60000, seed=78))
    return p


def run_cli(*args):
    return cli.main(["lz4-torch", "--backend", "host", *map(str, args)])


def run_jax_cli(*args):
    return jcli.main(["lz4-tpu", "--backend", "host", *map(str, args)])


def test_io_engine_hc_on_torch_backend(corpus, tmp_path):
    """-9 -B4 through io.engine on TorchBackend: B5 serves the HC blocks,
    and the file equals the JAX package's host-tier file byte for byte."""
    be = TorchBackend("cpu")
    ours = tmp_path / "ours.lz4"
    prefs = IoPrefs(level=9, block_size_id=4, verbosity=0)
    assert compress_file(str(corpus), str(ours), prefs,
                         backend=be)[0] == corpus.stat().st_size
    assert be.hc_encoded == 2          # the whole blocks, then the last one
    theirs = tmp_path / "theirs.lz4"
    jio.compress_file(str(corpus), str(theirs),
                      jio.IoPrefs(level=9, block_size_id=4, verbosity=0),
                      backend=JaxHost())
    assert ours.read_bytes() == theirs.read_bytes()
    out = tmp_path / "out.bin"
    decompress_file(str(ours), str(out), IoPrefs(verbosity=0), backend=be)
    assert out.read_bytes() == corpus.read_bytes()


def test_compress_decompress_roundtrip(corpus, tmp_path):
    assert run_cli("-f", corpus) == 0
    lz4f = str(corpus) + ".lz4"
    out = tmp_path / "out.bin"
    assert run_cli("-d", "-f", lz4f, out) == 0
    assert out.read_bytes() == corpus.read_bytes()
    assert run_cli("-t", lz4f) == 0


@pytest.mark.parametrize("flags", [["-1"], ["-9", "-B4"], ["-3", "-BD"],
                                   ["--fast=8"], ["-B5", "-BX"],
                                   ["--no-frame-crc", "--content-size"],
                                   ["-12"], ["-B33000"],
                                   ["--max-dist=2000", "-B4"]])
def test_cross_decode_and_same_bytes(corpus, tmp_path, flags):
    ours, theirs = tmp_path / "ours.lz4", tmp_path / "theirs.lz4"
    assert run_cli("-f", *flags, corpus, ours) == 0
    assert run_jax_cli("-f", *flags, corpus, theirs) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    a, b = tmp_path / "a.out", tmp_path / "b.out"
    assert run_jax_cli("-d", "-f", ours, a) == 0        # theirs reads ours
    assert run_cli("-d", "-f", theirs, b) == 0          # ours reads theirs
    assert a.read_bytes() == b.read_bytes() == corpus.read_bytes()


def test_test_mode_and_errors(corpus, tmp_path):
    assert run_cli("-f", corpus) == 0
    blob = bytearray((tmp_path / "data.bin.lz4").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    bad = tmp_path / "bad.lz4"
    bad.write_bytes(blob)
    with pytest.raises(SystemExit):
        run_cli("-t", bad)
    with pytest.raises(SystemExit):
        run_cli("-f", "-B31", corpus, tmp_path / "x.lz4")
    with pytest.raises(SystemExit):
        run_cli("-9", "--max-dist=2000", "-f", corpus, tmp_path / "x.lz4")


def test_default_backend_is_the_gpu(corpus, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["lz4-torch", "-f", str(corpus)])
    assert "device='cpu'" in capsys.readouterr().err
    assert not os.path.exists(str(corpus) + ".lz4")
    with pytest.raises(SystemExit):
        cli.main(["lz4-torch", "--backend", "tpu", "-f", str(corpus)])
    assert "unknown backend" in capsys.readouterr().err


def test_multiple_recursive_and_dictionary(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(3):
        (d / f"f{i}.bin").write_bytes(gen_buffer(5000, seed=i))
    assert run_cli("-r", "-f", d) == 0
    assert all((d / f"f{i}.bin.lz4").exists() for i in range(3))
    base = gen_buffer(65536, match_prob=0.8, seed=4)
    dict_p = tmp_path / "dict.bin"
    dict_p.write_bytes(base)
    data_p = tmp_path / "data.bin"
    data_p.write_bytes(base[:30000] + gen_buffer(10000, seed=5))
    withd = tmp_path / "withd.lz4"
    assert run_cli("-f", "-D", dict_p, data_p, withd) == 0
    out = tmp_path / "rt.bin"
    assert run_jax_cli("-d", "-f", "-D", dict_p, withd, out) == 0
    assert out.read_bytes() == data_p.read_bytes()


def test_list_legacy_and_skippable(corpus, tmp_path, capsys):
    assert run_cli("-f", "--content-size", corpus) == 0
    lz4f = str(corpus) + ".lz4"
    leg = tmp_path / "leg.lz4"
    assert run_cli("-l", "-f", corpus, leg) == 0
    assert struct.unpack("<I", leg.read_bytes()[:4])[0] == 0x184C2102
    jleg = tmp_path / "jleg.lz4"
    assert run_jax_cli("-l", "-f", corpus, jleg) == 0
    assert leg.read_bytes() == jleg.read_bytes()
    out = tmp_path / "leg.out"
    assert run_cli("-d", "-f", jleg, out) == 0
    assert out.read_bytes() == corpus.read_bytes()
    frames = list_frames(lz4f)
    assert [f.content_size for f in frames] == [corpus.stat().st_size]
    for verbose in (False, True):
        paths = [lz4f, str(leg)]
        assert format_list_output(paths, verbose) == \
            jio.format_list_output(paths, verbose)
    capsys.readouterr()
    assert cli.main(["lz4-torch", "--list", "-m", lz4f, str(leg)]) == 0
    assert capsys.readouterr().out.strip() == \
        jio.format_list_output([lz4f, str(leg)])
    data = corpus.read_bytes()
    skip = tmp_path / "skip.lz4"
    skip.write_bytes(write_skippable_frame(b"meta") + compress_frame(
        data, backend=TorchBackend("cpu")))
    assert run_cli("-d", "-f", skip, out) == 0
    assert out.read_bytes() == data


def test_sparse_output(tmp_path):
    payload = b"A" * 100 + b"\x00" * 300000 + b"B" * 100 + b"\x00" * 9000
    p = tmp_path / "sparse.bin"
    with open(p, "wb") as f:
        w = SparseWriter(f)
        for i in range(0, len(payload), 7777):
            w.write(payload[i: i + 7777])
        w.close()
    assert p.read_bytes() == payload
    src = tmp_path / "z.bin"
    src.write_bytes(payload)
    assert run_cli("-f", src) == 0
    for flag in ("--sparse", "--no-sparse"):
        out = tmp_path / f"z{flag}.out"
        assert run_cli("-d", "-f", flag, str(src) + ".lz4", out) == 0
        assert out.read_bytes() == payload


def test_bench_mode(corpus, tmp_path, capsys):
    assert run_cli("-b1", "-e3", "-i0", corpus) == 0
    lines = capsys.readouterr().err.strip().splitlines()
    assert [int(x.split(":")[0]) for x in lines] == [1, 2, 3]
    assert run_cli("-f", corpus) == 0
    assert run_cli("-b", "-i0", str(corpus) + ".lz4") == 0
    assert "decode-only" in capsys.readouterr().err


def test_frame_file_objects(tmp_path):
    data = gen_text(150000, seed=9)
    p = tmp_path / "f.lz4"
    be = TorchBackend("cpu")
    with open_frame(p, "wb", level=9, backend=be) as f:
        for i in range(0, len(data), 40000):
            f.write(data[i: i + 40000])
    assert jreader.decompress_frame(p.read_bytes()) == data
    with open_frame(p, "rb", backend=be) as f:
        assert f.read(1000) + f.read() == data
    with pytest.raises(ValueError):
        open_frame(p, "ab")
    header, _ = parse_frame_header(p.read_bytes())
    assert header.block_size_id == 4
