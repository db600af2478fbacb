"""Share of the calls' idle card time under no serve/* region of the program."""
from chipbench.program_spans import idle_unnamed_share as read  # noqa: F401
