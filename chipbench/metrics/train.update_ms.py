"""Device ms a step of the optimizer's kernels (under train/update)."""
from chipbench.readers import train_update_ms as read  # noqa: F401
