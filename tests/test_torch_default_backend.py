"""The port's default backend is the card (`TorchBackend()`), where the JAX
package's is the host until `install_tpu_backend()` installs
`TpuBackend`. Like for like, the bytes agree: the one-shot surfaces on
`TorchBackend` (here on the CPU: the kernels' plain versions) write
`TpuBackend`'s frames (the Pallas kernels in interpret mode on the CPU,
as `LZ4_TPU_PALLAS_CPU=1` asks), at levels 1, 2 and 9, and each frame
decodes through the other package. `backend=HostBackend()` gives the
host default of the reference. Tolerance: exact.
"""
import pytest

jax = pytest.importorskip("jax")

import lz4_tpu  # noqa: E402
from lz4_tpu.block import backend as jbackend  # noqa: E402
from lz4_tpu.parallel.engine import TpuBackend  # noqa: E402
import lz4_tpu_torch  # noqa: E402
from lz4_tpu_torch.block import backend  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

DATA = gen_text(20000, seed=41) + gen_buffer(9000, 0.8, seed=42)


@pytest.fixture(scope="module")
def backends():
    mp = pytest.MonkeyPatch()
    mp.setenv("LZ4_TPU_PALLAS_CPU", "1")
    yield TorchBackend("cpu"), TpuBackend()
    mp.undo()


@pytest.mark.parametrize("level", [1, 2, 9])
def test_one_shot_on_the_card_backend_writes_tpu_backend_frames(
        backends, level):
    port_be, jax_be = backends
    port = lz4_tpu_torch.compress(DATA, level, backend=port_be)
    ref = lz4_tpu.compress(DATA, level, backend=jax_be)
    assert port == ref
    assert lz4_tpu.decompress(port, backend=jax_be) == DATA
    assert lz4_tpu_torch.decompress(ref, backend=port_be) == DATA


@pytest.mark.parametrize("level", [1, 2, 9])
def test_host_backend_gives_the_reference_default(monkeypatch, level):
    """The reference's default before install_tpu_backend() (a fresh
    process-wide default) is its host tier; the port's HostBackend
    writes the same bytes."""
    monkeypatch.setattr(jbackend, "_DEFAULT", None)
    assert isinstance(jbackend.default_backend(), jbackend.HostBackend)
    port = lz4_tpu_torch.compress(DATA, level, backend=HostBackend())
    assert port == lz4_tpu.compress(DATA, level)


def test_default_backend_is_the_card(monkeypatch):
    """No argument means TorchBackend on the GPU, made at first use."""
    made = []
    monkeypatch.setattr(backend, "_DEFAULT", None)
    monkeypatch.setattr("lz4_tpu_torch.parallel.engine.TorchBackend",
                        lambda: made.append(1) or "card")
    assert backend.default_backend() == "card" and made == [1]
    assert backend.default_backend() == "card" and made == [1]
