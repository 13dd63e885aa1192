"""The port's spans (`lz4_tpu_torch.spans`) on the CPU: nothing is
recorded, and `record_function` is never called, while no profiler runs;
under `torch.profiler` the compress path's calls carry their `lz4t.`
spans, nested and in order; and the kernel loader keeps its builds."""
import numpy as np
import pytest
import torch

from lz4_tpu_torch import _build, spans
from lz4_tpu_torch.block.encode_cuda import encode_blocks
from lz4_tpu_torch.parallel.engine import TorchBackend


def _blocks(n=3, size=700, seed=5):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 6, size, dtype=np.uint8))
            for _ in range(n)]


def _profile(fn):
    """fn() under a CPU profiler: its result and the `lz4t.` spans as
    (name, start, end), in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = fn()
    got = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("lz4t.")]
    return res, sorted(got, key=lambda s: (s[1], -s[2]))


def _forbid_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_off_is_the_shared_null_context(monkeypatch):
    _forbid_record_function(monkeypatch)
    a, b = spans.span("lz4t.pack"), spans.span("lz4t.d2h")
    assert a is b is spans._OFF
    with a:
        pass


def test_the_compress_path_records_nothing_off(monkeypatch):
    blocks = _blocks()
    be = TorchBackend("cpu", min_device_size=16)
    want = be.compress_batch(blocks, level=1)
    _forbid_record_function(monkeypatch)
    assert be.compress_batch(blocks, level=1) == want


@pytest.mark.parametrize("level", [1, 9])
def test_a_call_carries_its_steps_in_order(level):
    blocks = _blocks()
    be = TorchBackend("cpu", min_device_size=16)
    want = be.compress_batch(blocks, level=level)
    got, recorded = _profile(lambda: be.compress_batch(blocks, level=level))
    assert got == want
    assert [s[0] for s in recorded[:1]] == ["lz4t.compress_batch"]
    _, a, b = recorded[0]
    inner = recorded[1:]
    assert all(a <= s <= e <= b for _, s, e in inner)
    names = [n for n, _, _ in inner]
    # the batch moves once: the wrapper finds it on its device
    assert names == ["lz4t.pack", "lz4t.h2d", "lz4t.launch", "lz4t.d2h",
                     "lz4t.to_bytes"]
    for (_, _, e1), (_, s2, _) in zip(inner, inner[1:]):
        assert e1 <= s2                     # one after another


def test_the_device_entry_on_resident_tensors_records_launch_alone():
    blocks = _blocks(2, 512)
    src = torch.zeros((2, 512), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        src[i] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    lens = torch.full((2,), 512, dtype=torch.int32)
    (out, csizes, _), recorded = _profile(
        lambda: encode_blocks(src, lens, cap_n=512))
    assert [n for n, _, _ in recorded] == ["lz4t.launch"]
    assert int(csizes.min()) > 0


class _FakeNvcc:
    """Stands in for nvcc's process: writes the library it is asked
    for."""

    def __init__(self, cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"not a library")
        self.returncode = 0

    def communicate(self):
        return b"ptxas info: 0 registers", None


class _FakeLib:
    def __getattr__(self, name):
        return self

    def __call__(self, *args):
        return 0


def _fake_toolchain(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build, "built", {})
    monkeypatch.setattr(_build, "_LIBS", {})


def test_builds_are_kept_and_found_libraries_are_not(monkeypatch, tmp_path):
    _fake_toolchain(monkeypatch, tmp_path)
    secs = _build.build(["encode_serial"])
    assert set(_build.built) == {"encode_serial"}
    assert _build.built["encode_serial"] == secs["encode_serial"] >= 0.0
    _build.build(["encode_hc"], defines=("LZ4T_X=1",))
    assert set(_build.built) == {"encode_serial", "encode_hc:LZ4T_X=1"}
    _build.built.clear()
    assert _build.build(["encode_serial"]) == {"encode_serial": 0.0}
    assert _build.built == {}                  # found built: a warm run


def test_a_build_at_load_is_a_span(monkeypatch, tmp_path):
    _fake_toolchain(monkeypatch, tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    _, recorded = _profile(lambda: _build.load("encode_hc"))
    assert [n for n, _, _ in recorded] == ["lz4t.build"]
    assert set(_build.built) == {"encode_hc"}
    _, recorded = _profile(lambda: _build.load("encode_hc"))
    assert recorded == []                      # loaded: nothing to build
