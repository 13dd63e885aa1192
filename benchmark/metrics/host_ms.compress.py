"""`host_ms.compress`: `benchmark.layers.host_ms`,
in the cells that report `compress_MBs`."""
from benchmark.layers import host_ms as read  # noqa: F401
