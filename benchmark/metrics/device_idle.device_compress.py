"""`device_idle.device_compress`: `benchmark.layers.device_idle`,
in the cells that report `device_compress_MBs`."""
from benchmark.layers import device_idle as read  # noqa: F401
