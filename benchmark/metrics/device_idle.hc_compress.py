"""`device_idle.hc_compress`: `benchmark.layers.device_idle`,
in the cells that report `hc_compress_MBs`."""
from benchmark.layers import device_idle as read  # noqa: F401
