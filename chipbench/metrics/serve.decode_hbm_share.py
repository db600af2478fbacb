"""Bytes the decode steps must move over their time at the HBM peak, in %."""
from chipbench.readers import decode_hbm_share as read  # noqa: F401
