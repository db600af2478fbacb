"""Share of the MoE layers' prefill device time launched under moe/experts."""
from chipbench.program_spans import moe_expert_gemm_share as read  # noqa: F401
