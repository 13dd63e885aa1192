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
from lz4_tpu_torch import _build, native, xxh32_device
from lz4_tpu_torch.block import (backend, decode_cuda, decode_wave,
                                 encode_cuda, encode_hc, encode_wave)
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.batch import pack_blocks
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.decode_wave import wave_decode_batch
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.block.encode_hc import encode_blocks_hc
from lz4_tpu_torch.block.encode_wave import find_matches_batch
from lz4_tpu_torch.examples import (sharded_batch, simple_buffer,
                                    turbo_wave_mode)
from lz4_tpu_torch.frame.batch import (compress_frames_wave,
                                       decompress_frames_wave)
from lz4_tpu_torch.native import blockcodec
from lz4_tpu_torch.probes import (b1_split, b4_split, b5_split, decode_split,
                                  fullbench, gather_probe, lane_probe,
                                  level2_route, torture, walk_probe)
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
    # the host tools: the fuzzer's device legs and the micro-benchmark
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torture.Options()
    for argv in ([], ["--kernels", "--wave"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torture.main(["--seconds", "0", *argv])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fullbench.main(["--seconds", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fullbench.run(None, B=1, NB=256, seconds=0)


def _wrapper_case(name, device):
    """(module, call of its product-kernel wrapper on `device`, the plain
    version's result on the same arrays) of kernel `name`."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, 4, (2, 64), dtype=np.uint8))
    lens = torch.tensor([64, 37], dtype=torch.int32)
    if name == "B1":
        mod, fn, plain = encode_cuda, encode_cuda.encode_blocks, \
            encode_cuda.encode_blocks_plain
        kw = {"cap_n": 64}
    elif name == "B2":
        rows = torch.from_numpy(pack_blocks(
            [blockcodec.compress(b"abc" * 20), b"\x50abcd"], cap=64)[0])
        mod, fn, plain = decode_cuda, decode_cuda.decode_blocks, \
            decode_cuda.decode_blocks_plain
        kw = {"cap_out": 64}
    elif name == "B3":
        rows = torch.zeros((2, 1, decode_wave.WCAP), dtype=torch.uint8)
        rows[:, 0, 0] = 0x20                  # two literals a stream
        lens = torch.tensor([2, 1], dtype=torch.int32)
        mod, fn, plain = decode_wave, decode_wave.wave_decode, \
            decode_wave.wave_decode_plain
        kw = {}
    elif name == "B4":
        mod, fn, plain = encode_wave, encode_wave.find_matches, \
            encode_wave.find_matches_plain
        kw = {}
    elif name == "B5":
        mod, fn, plain = encode_hc, encode_hc.encode_blocks_hc, \
            encode_hc.encode_blocks_hc_plain
        kw = {"cap_n": 64}
    else:
        mod, fn, plain = xxh32_device, xxh32_device.xxh32_blocks, \
            xxh32_device.xxh32_blocks_plain
        kw = {"cap": 64}
    want = plain(rows, lens, **kw)
    return mod, lambda: fn(rows.to(device), lens.to(device), **kw), want


@pytest.mark.parametrize("name", ["B1", "B2", "B3", "B4", "B5", "B6"])
def test_a_wrapper_runs_plain_on_the_cpu_and_raises_elsewhere(name):
    """Each product kernel's wrapper dispatches on the batch's device:
    the CPU runs the plain version inside the `lz4t.launch` span (no
    launch counted, and no `lz4t.h2d`: the batch is already there), a
    device with no kernel raises a ValueError that names the kernel."""
    mod, call, want = _wrapper_case(name, "cpu")
    before = mod.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = call()
    assert [e.name for e in prof.events()
            if e.name.startswith("lz4t.")] == ["lz4t.launch"]
    assert mod.launches == before
    for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x
                      for x in (got, want))):
        assert torch.equal(g, w)
    _, call, _ = _wrapper_case(name, "meta")
    with pytest.raises(ValueError, match=f"no {name} kernel for device meta"):
        call()
    assert mod.launches == before


def test_native_is_checked_for_imports():
    assert "lz4_tpu_torch.native" in _modules()
    assert PKG / "native" / "__init__.py" in _port_files()
    for m in ("cli", "bench", "bench_harness", "xxh32_device", "io.engine",
              "frame.file", "block.encode_hc", "probes.b1_split",
              "block.encode_sortscan", "probes.b4_split",
              "probes.level2_route", "probes.decode_split", "xxh64",
              "probes.walk_probe", "probes.gather_probe",
              "probes.lane_probe", "probes.torture", "probes.fullbench",
              "checkframe",
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
