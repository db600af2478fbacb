"""Share of the steps' time with nothing on the card, in %."""
from chipbench.readers import idle_share_steps as read  # noqa: F401
