"""Mean device ms of a decode step, from the program's CUDA events."""
from chipbench.readers import decode_step_ms as read  # noqa: F401
