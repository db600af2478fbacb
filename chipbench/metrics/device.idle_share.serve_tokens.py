"""Share of the calls' time with nothing on the card, in %."""
from chipbench.readers import idle_share_calls as read  # noqa: F401
