"""Every teaching program of the port (`lz4_tpu_torch.examples`) runs on
the CPU: the default backend set to the host tier, or `device="cpu"`
(gloo for `sharded_batch`). Where the JAX example's output holds no time
and no device count, the port's output equals it line for line."""
import importlib
import importlib.util
import pathlib

import pytest

jax = pytest.importorskip("jax")

from lz4_tpu.block import backend as jbackend  # noqa: E402
from lz4_tpu_torch.block import backend  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

EXAMPLES = [
    "simple_buffer",
    "file_compress",
    "block_streaming_double_buffer",
    "block_streaming_ring_buffer",
    "block_streaming_line_by_line",
    "streaming_hc_ring_buffer",
    "dictionary_random_access",
    "frame_compress",
    "bench_functions",
    "sharded_batch",
    "turbo_wave_mode",
]
# bench_functions prints times, sharded_batch the device count
SAME_OUTPUT = [n for n in EXAMPLES
               if n not in ("bench_functions", "sharded_batch")]
ON_DEVICE = ("sharded_batch", "turbo_wave_mode")    # take device="cpu"


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, name, path, **kw):
    if name == "file_compress":
        mod.main(str(path), **kw)
    else:
        mod.main(**kw)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_runs(name, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(backend, "_DEFAULT", backend.HostBackend())
    monkeypatch.setattr(jbackend, "_DEFAULT", jbackend.HostBackend())
    path = tmp_path / "sample.bin"
    path.write_bytes(b"example payload " * 4096)
    mod = importlib.import_module(f"lz4_tpu_torch.examples.{name}")
    if hasattr(mod, "N"):                # shrink micro-bench workloads
        monkeypatch.setattr(mod, "N", 262144)
    _run(mod, name, path, **({"device": "cpu"} if name in ON_DEVICE
                             else {}))
    out = capsys.readouterr().out
    assert out.strip()
    if name in SAME_OUTPUT:
        _run(_jax_example(name), name, path)
        assert out == capsys.readouterr().out
