"""Comparison-based profiling — method 1 of the paper (§3).

Run an identical application under two communication implementations,
aggregate per-region times over many runs, and divide the baseline tree by
the experimental tree. Values > 1: experimental faster; < 1: slower;
~1: equal. ``hotspots()`` then lists the worst regions — 'a starting point
for optimization efforts'.

:class:`ProfileReport` is the *unified* report type both comparison
front-ends render to: GraphFrame comparisons
(:meth:`ComparisonResult.to_report`) and trace diffs
(:meth:`repro.trace.TraceDiff.to_report`) emit the same
rows-plus-:class:`~repro_torch.core.analyses.Finding` shape, so downstream
consumers (the workload bench harness, verify gates, humans reading the
rendered text) handle "two live runs compared" and "two replays diffed"
identically.

A copy of ``repro.core.comparison``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from .analyses import Finding
from .collector import Collector, reset_global_collector
from .events import Event
from .graphframe import GraphFrame


@dataclasses.dataclass
class ReportRow:
    """One compared item: a region path (GraphFrame comparison) or a
    ``phase/rank`` cell (trace diff). ``baseline``/``candidate`` are in
    ``unit`` (seconds for region times, nanoseconds for match latency)."""

    path: str
    baseline: float
    candidate: float
    unit: str = "s"

    @property
    def delta(self) -> float:
        return self.candidate - self.baseline

    @property
    def ratio(self) -> float:
        """candidate / baseline (> 1: candidate slower/deeper)."""
        return (self.candidate / self.baseline if self.baseline
                else float("inf") if self.candidate else 1.0)

    def __str__(self) -> str:
        return (f"{self.path}: {self.baseline:.6g} -> "
                f"{self.candidate:.6g} {self.unit} ({self.ratio:.2f}x)")


@dataclasses.dataclass
class ProfileReport:
    """The one report type shared by GraphFrame comparisons and trace
    diffs: per-item rows plus detector findings."""

    kind: str                     # "graphframe" | "trace"
    baseline_name: str
    candidate_name: str
    rows: List[ReportRow] = dataclasses.field(default_factory=list)
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def worst(self, n: int = 10) -> List[ReportRow]:
        """Rows where the candidate regressed hardest (largest delta)."""
        return sorted(self.rows, key=lambda r: -r.delta)[:n]

    def finding_kinds(self) -> List[str]:
        return sorted({f.kind for f in self.findings})

    def regressed(self) -> bool:
        return bool(self.findings)

    def render(self, limit: int = 10) -> str:
        lines = [f"{self.kind} report: {self.baseline_name!r} -> "
                 f"{self.candidate_name!r}, {len(self.rows)} rows, "
                 f"{len(self.findings)} finding(s)"]
        lines += ["  " + str(r) for r in self.worst(limit)]
        lines += ["  " + str(f) for f in self.findings[:limit]]
        return "\n".join(lines)


@dataclasses.dataclass
class ComparisonResult:
    baseline_name: str
    experimental_name: str
    baseline: GraphFrame          # aggregated over runs
    experimental: GraphFrame
    ratio: GraphFrame             # baseline / experimental
    runs: Dict[str, List[GraphFrame]] = dataclasses.field(default_factory=dict)

    def hotspots(self, n: int = 10):
        """Regions where the experimental implementation performs worst."""
        return self.ratio.hotspots(n=n, metric="value", ascending=True)

    def wins(self, n: int = 10):
        return self.ratio.hotspots(n=n, metric="value", ascending=False)

    def tree(self, **kw) -> str:
        return self.ratio.tree(**kw)

    def to_report(self, slowdown_factor: float = 2.0) -> ProfileReport:
        """Render this comparison as the unified :class:`ProfileReport`
        (the same type trace diffs produce). Leaves where the
        experimental implementation is ``slowdown_factor``x slower than
        the baseline become ``"hotspot"`` findings, severity = excess
        seconds per occurrence."""
        rows: List[ReportRow] = []
        findings: List[Finding] = []
        exp = {"/".join(p): n.metric("value")
               for p, n in self.experimental.walk()}
        for path, node in self.baseline.walk():
            if node.children:
                continue
            key = "/".join(path)
            a = node.metric("value")                 # inclusive seconds
            b = exp.get(key, float("nan"))
            if a != a:
                continue
            if b != b:
                # a region the experimental run never produced is itself
                # a finding, not something to silently drop
                findings.append(Finding(
                    kind="missing",
                    message=(f"'{key}' profiled on "
                             f"{self.baseline_name!r} but absent from "
                             f"{self.experimental_name!r}"),
                    severity=a))
                continue
            rows.append(ReportRow(path=key, baseline=a, candidate=b))
            if a > 0 and b >= slowdown_factor * a:
                findings.append(Finding(
                    kind="hotspot",
                    message=(f"'{key}' is {b / a:.1f}x slower on "
                             f"{self.experimental_name!r} "
                             f"({a * 1e3:.3f} -> {b * 1e3:.3f} ms)"),
                    severity=b - a))
        findings.sort(key=lambda f: -f.severity)
        return ProfileReport(kind="graphframe",
                             baseline_name=self.baseline_name,
                             candidate_name=self.experimental_name,
                             rows=rows, findings=findings)

    def mean_speedup(self, category_paths: Optional[Sequence[str]] = None) -> float:
        """Geometric-mean-free average ratio across (optionally filtered) leaves
        — the paper reports 'an average speedup of 3.58x across all MPI
        procedure calls'."""
        vals = []
        for path, node in self.ratio.walk():
            if node.children:
                continue
            if category_paths is not None and not any(
                s in "/".join(path) for s in category_paths
            ):
                continue
            v = node.metric("value")
            if v == v and v not in (float("inf"), float("-inf")):
                vals.append(v)
        return sum(vals) / len(vals) if vals else float("nan")


def profile_runs(
    app: Callable[[], None],
    n_runs: int = 5,
    warmup: int = 1,
    pid: int = 0,
) -> List[GraphFrame]:
    """Run ``app`` n times, each under a fresh collector; return one
    GraphFrame of inclusive mean times per run."""
    frames: List[GraphFrame] = []
    for _ in range(warmup):
        reset_global_collector(pid=pid)
        app()
    for _ in range(n_runs):
        col = reset_global_collector(pid=pid)
        app()
        events: List[Event] = col.drain()
        frames.append(GraphFrame.from_events(events))
    reset_global_collector(pid=pid)
    return frames


def compare(
    baseline_app: Callable[[], None],
    experimental_app: Callable[[], None],
    n_runs: int = 5,
    warmup: int = 1,
    baseline_name: str = "baseline",
    experimental_name: str = "experimental",
    metric: str = "mean",
) -> ComparisonResult:
    """The full method: N runs per implementation, mean-aggregate, divide."""
    base_runs = profile_runs(baseline_app, n_runs=n_runs, warmup=warmup)
    exp_runs = profile_runs(experimental_app, n_runs=n_runs, warmup=warmup)
    base = GraphFrame.aggregate(base_runs, metric=metric, how="mean")
    exp = GraphFrame.aggregate(exp_runs, metric=metric, how="mean")
    ratio = base.div(exp, metric="value")
    return ComparisonResult(
        baseline_name=baseline_name,
        experimental_name=experimental_name,
        baseline=base,
        experimental=exp,
        ratio=ratio,
        runs={baseline_name: base_runs, experimental_name: exp_runs},
    )


def compare_frames(
    baseline_runs: Sequence[GraphFrame],
    experimental_runs: Sequence[GraphFrame],
    metric: str = "mean",
    baseline_name: str = "baseline",
    experimental_name: str = "experimental",
) -> ComparisonResult:
    """Comparison from pre-collected per-run frames (e.g. from subprocesses)."""
    base = GraphFrame.aggregate(baseline_runs, metric=metric, how="mean")
    exp = GraphFrame.aggregate(experimental_runs, metric=metric, how="mean")
    return ComparisonResult(
        baseline_name=baseline_name,
        experimental_name=experimental_name,
        baseline=base,
        experimental=exp,
        ratio=base.div(exp, metric="value"),
        runs={baseline_name: list(baseline_runs),
              experimental_name: list(experimental_runs)},
    )
