"""Mean host ms a call of the program's serve/alloc_cache region, from the trace."""
from chipbench.program_spans import alloc_cache_ms as read  # noqa: F401
