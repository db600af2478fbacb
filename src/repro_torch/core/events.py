"""Event model for the profiling substrate.

An :class:`Event` is one completed occurrence of an annotated region —
the unit of data both profiling methods in the paper operate on.
Times are integer nanoseconds from a monotonic clock.

A copy of ``repro.core.events``: the port imports nothing of the JAX package.
Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(slots=True)
class Event:
    name: str
    path: Tuple[str, ...]          # full region nesting, root-first (incl. name)
    category: str                  # runtime-toggleable category ("api", "collective", ...)
    t_start: int                   # ns, monotonic
    t_end: int                     # ns, monotonic
    pid: int = 0                   # logical process (rank) id
    tid: int = 0                   # thread id (normalized small int)
    attrs: Optional[Dict[str, Any]] = None

    @property
    def duration(self) -> int:
        return self.t_end - self.t_start

    @property
    def key(self) -> str:
        """Stable string key for the region path ("a/b/c")."""
        return "/".join(self.path)

    def overlaps(self, other: "Event") -> int:
        """Temporal overlap in ns with another event (0 if disjoint)."""
        lo = max(self.t_start, other.t_start)
        hi = min(self.t_end, other.t_end)
        return max(0, hi - lo)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "path": list(self.path),
            "category": self.category,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "pid": self.pid,
            "tid": self.tid,
            "attrs": dict(self.attrs) if self.attrs else {},
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Event":
        return Event(
            name=d["name"],
            path=tuple(d["path"]),
            category=d.get("category", "app"),
            t_start=int(d["t_start"]),
            t_end=int(d["t_end"]),
            pid=int(d.get("pid", 0)),
            tid=int(d.get("tid", 0)),
            attrs=d.get("attrs") or None,
        )
