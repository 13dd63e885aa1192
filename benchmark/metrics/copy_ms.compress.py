"""`copy_ms.compress`: `benchmark.layers.copy_ms`,
in the cells that report `compress_MBs`."""
from benchmark.layers import copy_ms as read  # noqa: F401
