"""Mean host ms a call of the program's serve/capture region (decode warm-up, capture, instantiation)."""
from chipbench.program_spans import capture_ms as read  # noqa: F401
