"""`host_ms.device_compress`: `benchmark.layers.host_ms`,
in the cells that report `device_compress_MBs`."""
from benchmark.layers import host_ms as read  # noqa: F401
