"""pytest settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the `cuda` marker, and the `card` fixture, which
decides inside the test whether a CUDA card is present."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips elsewhere)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card tests run on the "
                    "card only")
    return torch.device("cuda", torch.cuda.current_device())
