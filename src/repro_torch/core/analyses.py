"""Findings of the automated analyses (paper §4.1 and method 2).

Only the :class:`Finding` record is ported so far, for
:mod:`repro_torch.checkpoint.straggler`; the detectors of
``repro.core.analyses`` come with a later slice. A copy of the JAX
package's class: the port imports nothing of the JAX package. Keep the two
in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .events import Event


@dataclasses.dataclass
class Finding:
    kind: str                 # "large_wait" | "contention" | "irregular" |
                              # "gap" | "long_traversal" | "umq_flood" |
                              # "orphan_posts" | "duplicate_match" |
                              # "reorder_inflation" | "straggler_rank" |
                              # "straggler" | "failure"
    message: str
    severity: float           # seconds of suspect time
    events: List[Event] = dataclasses.field(default_factory=list)
    pid: Optional[int] = None  # offending rank, when the detector knows it

    def __str__(self) -> str:
        return f"[{self.kind}] ({self.severity * 1e3:.3f} ms) {self.message}"

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready payload (events are dropped — they don't serialize
        compactly and live consumers only need the verdict)."""
        out: Dict[str, object] = {"kind": self.kind, "message": self.message,
                                  "severity": self.severity}
        if self.pid is not None:
            out["pid"] = self.pid
        return out
