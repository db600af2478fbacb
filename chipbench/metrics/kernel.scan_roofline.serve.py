"""The selective-scan forward kernel's roofline share over the prefills, in %."""
from chipbench.readers import scan_roofline_serve as read  # noqa: F401
