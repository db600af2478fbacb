"""Model FLOPs of the prefills over their regions' time at the bf16 peak, in %."""
from chipbench.readers import prefill_mfu as read  # noqa: F401
