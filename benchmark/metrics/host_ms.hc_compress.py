"""`host_ms.hc_compress`: `benchmark.layers.host_ms`,
in the cells that report `hc_compress_MBs`."""
from benchmark.layers import host_ms as read  # noqa: F401
