"""The flash forward kernel's roofline share over the prefills, in %."""
from chipbench.readers import flash_roofline_serve as read  # noqa: F401
