"""`copy_ms.hc_compress`: `benchmark.layers.copy_ms`,
in the cells that report `hc_compress_MBs`."""
from benchmark.layers import copy_ms as read  # noqa: F401
