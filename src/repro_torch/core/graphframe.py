"""Hatchet-analog GraphFrame (paper §3.2, Figs 1-3).

A :class:`GraphFrame` is a tree of region paths, each node carrying
aggregate statistics of the region's inclusive time across occurrences.

A copy of the construction, rendering and serialization parts of
``repro.core.graphframe`` (``from_events``, ``tree``, ``to_dict``): the
port imports nothing of the JAX package. Keep the two in step.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

from .events import Event


class Node:
    __slots__ = ("name", "children", "metrics")

    def __init__(self, name: str):
        self.name = name
        self.children: Dict[str, "Node"] = {}
        self.metrics: Dict[str, float] = {}

    def child(self, name: str) -> "Node":
        c = self.children.get(name)
        if c is None:
            c = Node(name)
            self.children[name] = c
        return c

    @property
    def mean(self) -> float:
        n = self.metrics.get("count", 0)
        return self.metrics.get("sum", 0.0) / n if n else float("nan")

    def metric(self, which: str) -> float:
        if which == "mean":
            return self.mean
        return self.metrics.get(which, float("nan"))


class GraphFrame:
    def __init__(self, root: Optional[Node] = None):
        self.root = root or Node("<root>")

    @staticmethod
    def from_events(events: Iterable[Event], unit: float = 1e-9) -> "GraphFrame":
        """Build a tree of inclusive times (seconds by default) from events."""
        gf = GraphFrame()
        for ev in events:
            node = gf.root
            for part in ev.path:
                node = node.child(part)
            dur = ev.duration * unit
            m = node.metrics
            m["count"] = m.get("count", 0) + 1
            m["sum"] = m.get("sum", 0.0) + dur
            m["sumsq"] = m.get("sumsq", 0.0) + dur * dur
            m["min"] = min(m.get("min", math.inf), dur)
            m["max"] = max(m.get("max", -math.inf), dur)
        return gf

    def tree(self, metric: str = "value", fmt: str = "{:.6f}",
             max_depth: Optional[int] = None, skip_nan: bool = False) -> str:
        lines: List[str] = []

        def has_value(node: Node) -> bool:
            v = node.metric(metric)
            if not math.isnan(v):
                return True
            return any(has_value(c) for c in node.children.values())

        def rec(node: Node, depth: int, prefix: str):
            if max_depth is not None and depth > max_depth:
                return
            names = [n for n in sorted(node.children)
                     if not skip_nan or has_value(node.children[n])]
            for i, name in enumerate(names):
                child = node.children[name]
                last = i == len(names) - 1
                v = child.metric(metric)
                if math.isnan(v):
                    v = child.metric("mean")
                branch = "└─ " if last else "├─ "
                lines.append(f"{prefix}{branch}{fmt.format(v)} {name}")
                rec(child, depth + 1, prefix + ("   " if last else "│  "))

        rec(self.root, 0, "")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        def rec(node: Node) -> dict:
            return {
                "name": node.name,
                "metrics": dict(node.metrics),
                "children": [rec(c) for _, c in sorted(node.children.items())],
            }

        return rec(self.root)
