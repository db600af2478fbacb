"""The flash kernels' roofline share over the traced steps, in %."""
from chipbench.readers import flash_roofline_train as read  # noqa: F401
