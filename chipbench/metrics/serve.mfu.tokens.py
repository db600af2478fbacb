"""Model FLOPs of whole calls over their host time at the bf16 peak, in %."""
from chipbench.readers import serve_mfu as read  # noqa: F401
