"""Mean device ms a call of the kernels launched under serve/prefill and a moe/* span."""
from chipbench.program_spans import moe_prefill_ms as read  # noqa: F401
