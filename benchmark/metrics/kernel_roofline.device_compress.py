"""`kernel_roofline.device_compress`: `benchmark.layers.kernel_roofline`,
in the cells that report `device_compress_MBs`."""
from benchmark.layers import kernel_roofline as read  # noqa: F401
