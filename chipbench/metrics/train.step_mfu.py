"""Model FLOPs of the traced steps over their host time at the bf16 peak, in %."""
from chipbench.readers import train_step_mfu as read  # noqa: F401
