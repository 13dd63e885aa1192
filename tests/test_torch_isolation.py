"""The port stands alone: it imports neither JAX nor the JAX package, and
it never drops to the CPU (or to anything else) on its own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import lz4_tpu_torch
from lz4_tpu_torch import _build, native
from lz4_tpu_torch.block import backend
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.decode_wave import wave_decode_batch
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc
from lz4_tpu_torch.block.encode_wave import find_matches_batch
from lz4_tpu_torch.examples import (sharded_batch, simple_buffer,
                                    turbo_wave_mode)
from lz4_tpu_torch.frame.batch import (compress_frames_wave,
                                       decompress_frames_wave)
from lz4_tpu_torch.probes import (b1_split, b4_split, b5_split, decode_split,
                                  gather_probe, lane_probe, level2_route,
                                  walk_probe)
from lz4_tpu_torch.parallel.engine import TorchBackend
from lz4_tpu_torch.xxh32_device import xxh32_blocks

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
PKG = pathlib.Path(lz4_tpu_torch.__file__).resolve().parent


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_imports_without_jax_or_lz4_tpu():
    code = (
        "import sys, importlib\n"
        "for k in list(sys.modules):\n"
        "    if k.split('.')[0] in ('jax', 'jaxlib', 'lz4_tpu'):\n"
        "        del sys.modules[k]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lz4_tpu'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_lz4_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "lz4_tpu"), (path, name)


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend()
    src = np.zeros((2, 64), np.uint8)
    lens = np.array([64, 3], np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_blocks(src, lens, cap_n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_blocks(src, lens, cap_out=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_blocks_hc(src, lens, cap_n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xxh32_blocks(src, lens, cap=64)
    arenas = np.zeros((2, 4, 1088), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wave_decode_batch(arenas, lens)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        find_matches_batch([b"abc" * 100])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compress_frames_wave([b"abc" * 100])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decompress_frames_wave([b""])
    # the one-shot surfaces and the examples on the default backend
    monkeypatch.setattr(backend, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lz4_tpu_torch.compress(b"abc" * 100)
    frame = lz4_tpu_torch.compress(b"abc" * 100, backend=HostBackend())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lz4_tpu_torch.decompress(frame)
    for example in (simple_buffer, turbo_wave_mode, sharded_batch):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main()


def test_native_is_checked_for_imports():
    assert "lz4_tpu_torch.native" in _modules()
    assert PKG / "native" / "__init__.py" in _port_files()
    for m in ("cli", "bench", "bench_harness", "xxh32_device", "io.engine",
              "frame.file", "block.encode_hc", "probes.b1_split",
              "block.encode_sortscan", "probes.b4_split",
              "probes.level2_route", "probes.decode_split", "xxh64",
              "probes.walk_probe", "probes.gather_probe",
              "probes.lane_probe",
              "examples", *(f"examples.{e}" for e in EXAMPLES)):
        assert f"lz4_tpu_torch.{m}" in _modules()
    assert str(PKG / "native" / "framewalk.c") in native.sources()


def test_host_backend_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="C build failed"):
        HostBackend()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no compiler here"):
        _build.build(["decode_serial"])
    assert not any((tmp_path / "build").glob("*.so"))


def test_library_key_covers_headers_and_defines(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include <cstdint>\n')
    (csrc / "k.cuh").write_text('#include "deep.cuh"\n')
    (csrc / "deep.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert sorted(pathlib.Path(p).name for p in _build.sources("k")) == [
        "deep.cuh", "k.cu", "k.cuh"]
    key = _build.library_path("k")
    assert _build.library_path("k") == key
    assert _build.library_path("k", ("LZ4T_B1_NOLITS",)) != key
    (csrc / "deep.cuh").write_text("// v2\n")
    assert _build.library_path("k") != key


def test_probe_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b1_split.main([]) != 0
    assert capsys.readouterr().out == ""


def test_b5_probe_needs_a_gpu(monkeypatch, capsys):
    assert "lz4_tpu_torch.probes.b5_split" in _modules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b5_split.main([]) != 0
    assert capsys.readouterr().out == ""


def test_b4_probe_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b4_split.main([]) != 0
    assert capsys.readouterr().out == ""


def test_level2_probe_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert level2_route.main([]) != 0
    assert capsys.readouterr().out == ""


def test_decode_probe_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert decode_split.main([]) != 0
    assert capsys.readouterr().out == ""


def test_probe_kernels_raise_without_gpu(monkeypatch):
    """The probes of the TPU tools run on the card unless asked for the
    CPU (their plain versions)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, ns = walk_probe.inputs(rows=1, words=8, n=16)
    x = np.zeros((1, 8, 128), np.int32)
    src = np.zeros((8, 128), np.int32)
    calls = [lambda: walk_probe.walk(words, ns, "a"),
             lambda: walk_probe.burn(np.ones(1, np.float32), "parallel"),
             lambda: gather_probe.gather("lane", x, x),
             lambda: gather_probe.gather("chase", x),
             lambda: lane_probe.gather("a0", src, src),
             lambda: lane_probe.loop("base", src, 4),
             lambda: lane_probe.wave(src, 4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    acc, _, _ = walk_probe.walk(words, ns, "a", device="cpu")
    assert acc.device.type == "cpu"


@pytest.mark.parametrize("probe", [walk_probe, gather_probe, lane_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_probes_need_a_gpu(monkeypatch, capsys, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) != 0
    assert capsys.readouterr().out == ""
