"""`device_idle.compress`: `benchmark.layers.device_idle`,
in the cells that report `compress_MBs`."""
from benchmark.layers import device_idle as read  # noqa: F401
