"""lz4_tpu_torch — the LZ4 codec framework of `lz4_tpu`, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `lz4_tpu` is the reference this port is held against;
nothing here imports it or JAX. Entry points run on the GPU unless the
caller passes `device="cpu"`, which runs each kernel's plain PyTorch
version instead. The kernels are built from `csrc/` with nvcc at first
use (`lz4_tpu_torch._build`).
"""

__version__ = "0.1.0"

from lz4_tpu_torch.constants import compress_bound  # noqa: F401
from lz4_tpu_torch.xxh32 import XXH32State, xxh32  # noqa: F401

