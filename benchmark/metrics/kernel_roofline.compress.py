"""`kernel_roofline.compress`: `benchmark.layers.kernel_roofline`,
in the cells that report `compress_MBs`."""
from benchmark.layers import kernel_roofline as read  # noqa: F401
