"""The decode-attention kernels' share of their roofline over the decode steps, in %."""
from chipbench.decode_attention import decode_attn_roofline as read  # noqa: F401
