"""Mean host ms from a call's start to its prefill: cache allocation and decode capture."""
from chipbench.readers import pre_prefill_ms as read  # noqa: F401
