"""Hatchet-analog GraphFrame (paper §3.2, Figs 1-3).

A :class:`GraphFrame` is a tree of region paths, each node carrying
aggregate statistics of the region's inclusive time across occurrences
(and, after :func:`aggregate`, across runs). It supports:

  * aggregation across occurrences and runs: count/sum/mean/min/max/var
  * element-wise tree arithmetic aligned by path — ``baseline / experimental``
    is the paper's comparison ratio (values > 1: experimental faster)
  * a Hatchet-style tree renderer used for all figure reproductions
  * JSON (de)serialization

The implementation is pandas-free (pandas is not available offline) but
keeps the hierarchical-analysis property the paper chose Hatchet for.

A copy of ``repro.core.graphframe``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .events import Event

Path = Tuple[str, ...]

_METRICS = ("count", "sum", "min", "max", "sumsq")


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

    # derived statistics -------------------------------------------------
    @property
    def mean(self) -> float:
        n = self.metrics.get("count", 0)
        return self.metrics.get("sum", 0.0) / n if n else float("nan")

    @property
    def var(self) -> float:
        n = self.metrics.get("count", 0)
        if n < 1:
            return float("nan")
        m = self.mean
        return max(0.0, self.metrics.get("sumsq", 0.0) / n - m * m)

    def metric(self, which: str) -> float:
        if which == "mean":
            return self.mean
        if which == "var":
            return self.var
        if which == "std":
            return math.sqrt(self.var) if not math.isnan(self.var) else float("nan")
        return self.metrics.get(which, float("nan"))


class GraphFrame:
    def __init__(self, root: Optional[Node] = None):
        self.root = root or Node("<root>")

    # -- construction -----------------------------------------------------
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

    # -- traversal ---------------------------------------------------------
    def walk(self) -> Iterable[Tuple[Path, Node]]:
        def rec(node: Node, path: Path):
            for name in sorted(node.children):
                child = node.children[name]
                cpath = path + (name,)
                yield cpath, child
                yield from rec(child, cpath)

        yield from rec(self.root, ())

    def paths(self) -> List[Path]:
        return [p for p, _ in self.walk()]

    def node(self, path: Path) -> Optional[Node]:
        node = self.root
        for part in path:
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def value(self, path: Path, metric: str = "mean") -> float:
        n = self.node(path)
        return n.metric(metric) if n is not None else float("nan")

    # -- aggregation across runs (paper: "aggregated using a mean function") --
    @staticmethod
    def aggregate(
        frames: Sequence["GraphFrame"],
        metric: str = "mean",
        how: str = "mean",
    ) -> "GraphFrame":
        """Aggregate one metric across runs into a fresh GraphFrame whose
        per-node statistics are over the *runs* (count == number of runs in
        which the path appeared). ``how`` picks the headline 'value' metric:
        mean|min|max|sum|var of the per-run values."""
        out = GraphFrame()
        for gf in frames:
            for path, node in gf.walk():
                v = node.metric(metric)
                if math.isnan(v):
                    continue
                tgt = out.root
                for part in path:
                    tgt = tgt.child(part)
                m = tgt.metrics
                m["count"] = m.get("count", 0) + 1
                m["sum"] = m.get("sum", 0.0) + v
                m["sumsq"] = m.get("sumsq", 0.0) + v * v
                m["min"] = min(m.get("min", math.inf), v)
                m["max"] = max(m.get("max", -math.inf), v)
        # headline value
        for _, node in out.walk():
            node.metrics["value"] = node.metric("mean" if how == "mean" else how)
        return out

    # -- tree arithmetic (paper: "Hatchet provides the capability to perform
    #    simple arithmetic with GraphFrames") -------------------------------
    def _zip(self, other: "GraphFrame", op: Callable[[float, float], float],
             metric: str) -> "GraphFrame":
        out = GraphFrame()
        paths = set(self.paths()) | set(other.paths())
        for path in paths:
            a, b = self.value(path, metric), other.value(path, metric)
            node = out.root
            for part in path:
                node = node.child(part)
            try:
                v = op(a, b)
            except ZeroDivisionError:
                v = float("inf")
            node.metrics.update(count=1, sum=v, sumsq=v * v, min=v, max=v, value=v)
        return out

    def div(self, other: "GraphFrame", metric: str = "mean") -> "GraphFrame":
        return self._zip(other, lambda a, b: a / b, metric)

    def sub(self, other: "GraphFrame", metric: str = "mean") -> "GraphFrame":
        return self._zip(other, lambda a, b: a - b, metric)

    def add(self, other: "GraphFrame", metric: str = "mean") -> "GraphFrame":
        return self._zip(other, lambda a, b: a + b, metric)

    def mul(self, other: "GraphFrame", metric: str = "mean") -> "GraphFrame":
        return self._zip(other, lambda a, b: a * b, metric)

    __truediv__ = div
    __sub__ = sub
    __add__ = add
    __mul__ = mul

    # -- analysis helpers ---------------------------------------------------
    def hotspots(self, n: int = 10, metric: str = "value",
                 ascending: bool = True, leaf_only: bool = False
                 ) -> List[Tuple[Path, float]]:
        """Worst (smallest ratio, by default) regions first — the paper's
        'starting point for optimization efforts'."""
        items = []
        for path, node in self.walk():
            if leaf_only and node.children:
                continue
            v = node.metric(metric)
            if not math.isnan(v) and not math.isinf(v):
                items.append((path, v))
        items.sort(key=lambda kv: kv[1], reverse=not ascending)
        return items[:n]

    def total(self, metric: str = "sum") -> float:
        """Sum of top-level (root children) inclusive values."""
        return sum(
            c.metric(metric)
            for c in self.root.children.values()
            if not math.isnan(c.metric(metric))
        )

    # -- rendering (paper Figs 1-3) ------------------------------------------
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

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        def rec(node: Node) -> dict:
            return {
                "name": node.name,
                "metrics": dict(node.metrics),
                "children": [rec(c) for _, c in sorted(node.children.items())],
            }

        return rec(self.root)

    @staticmethod
    def from_dict(d: dict) -> "GraphFrame":
        def rec(dd: dict) -> Node:
            node = Node(dd["name"])
            node.metrics = dict(dd.get("metrics", {}))
            for cd in dd.get("children", []):
                node.children[cd["name"]] = rec(cd)
            return node

        return GraphFrame(rec(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "GraphFrame":
        return GraphFrame.from_dict(json.loads(s))
