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
from lz4_tpu_torch import _build
from lz4_tpu_torch.block.decode_cuda import decode_blocks
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.parallel.engine import TorchBackend

ROOT = pathlib.Path(__file__).resolve().parent.parent
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
