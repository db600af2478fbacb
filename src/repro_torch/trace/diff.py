"""Trace differ: the regression-detection primitive over replays.

Given two replays of the *same* recorded trace (or of two runs with the
same phase structure), align them phase-by-phase and rank-by-rank —
phases carry the (op, label, tag) identity of the collective that
produced them — and report deltas in the method-2 quantities:

  * PRQ traversal depth (queue entries examined per match),
  * UMQ length (unexpected messages pending, leaks included),
  * match latency (measured PRQ+UMQ search nanoseconds).

``TraceDiff.flags()`` turns aggregate deltas into the same
:class:`repro_torch.core.analyses.Finding` kinds the live detectors emit
(``long_traversal`` / ``umq_flood``), so "replay the trace on engine B
and diff against engine A" answers the what-if question directly: a
defective candidate engine is flagged, a healthy one diffs clean.

``TraceDiff.to_report()`` renders the diff as the unified
:class:`repro_torch.core.comparison.ProfileReport` — the same type GraphFrame
comparisons produce — so trace diffs and method-1 comparisons flow
through one report pipeline.

A copy of ``repro.trace.diff``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..core.analyses import NS_PER_QUEUE_ENTRY, Finding
from ..core.comparison import ProfileReport, ReportRow
from ..core.counters import CounterStat
from .replay import PhaseStats, ReplayResult

DEPTH = "match.prq.traversal_depth"
UMQ_LEN = "match.umq.length"
SEARCH = ("match.prq.search_ns", "match.umq.search_ns")


def _mean_count(stats: Dict[str, CounterStat], name: str
                ) -> Tuple[float, int, float]:
    """(mean, count, vmax) of one histogram, zeros when absent."""
    st = stats.get(name)
    if st is None or st.count == 0:
        return 0.0, 0, 0.0
    vmax = st.vmax if st.kind == "histogram" else 0.0
    return st.mean, st.count, vmax


def _search_ns(stats: Dict[str, CounterStat]) -> float:
    return sum(stats[n].total for n in SEARCH if n in stats)


@dataclasses.dataclass
class PhaseDelta:
    """One (phase, rank) cell of the diff. ``a`` is the baseline replay,
    ``b`` the candidate."""

    index: int
    label: str
    op: str
    rank: int
    depth_mean: Tuple[float, float]
    depth_count: Tuple[int, int]
    umq_len_mean: Tuple[float, float]
    umq_len_max: Tuple[float, float]
    match_ns: Tuple[float, float]

    @property
    def latency_delta_s(self) -> float:
        return (self.match_ns[1] - self.match_ns[0]) / 1e9

    def __str__(self) -> str:
        return (f"phase {self.index} '{self.label}' rank {self.rank}: "
                f"depth {self.depth_mean[0]:.1f}->{self.depth_mean[1]:.1f} "
                f"umq_max {self.umq_len_max[0]:.0f}->"
                f"{self.umq_len_max[1]:.0f} "
                f"latency {self.latency_delta_s * 1e3:+.3f} ms")


def _phase_deltas(pa: PhaseStats, pb: PhaseStats) -> List[PhaseDelta]:
    out: List[PhaseDelta] = []
    for rank in sorted(set(pa.stats) | set(pb.stats)):
        sa = pa.stats.get(rank, {})
        sb = pb.stats.get(rank, {})
        da_mean, da_count, _ = _mean_count(sa, DEPTH)
        db_mean, db_count, _ = _mean_count(sb, DEPTH)
        ua_mean, _, ua_max = _mean_count(sa, UMQ_LEN)
        ub_mean, _, ub_max = _mean_count(sb, UMQ_LEN)
        out.append(PhaseDelta(
            index=pa.index, label=pa.label, op=pa.op, rank=rank,
            depth_mean=(da_mean, db_mean),
            depth_count=(da_count, db_count),
            umq_len_mean=(ua_mean, ub_mean),
            umq_len_max=(ua_max, ub_max),
            match_ns=(_search_ns(sa), _search_ns(sb)),
        ))
    return out


@dataclasses.dataclass
class TraceDiff:
    a_mode: str
    b_mode: str
    deltas: List[PhaseDelta]

    def per_rank(self) -> Dict[int, Dict[str, float]]:
        """Aggregate deltas across phases, per rank (depth totals are
        sample-weighted so one deep phase is not averaged away)."""
        agg: Dict[int, Dict[str, float]] = {}
        for d in self.deltas:
            r = agg.setdefault(d.rank, {
                "depth_total_a": 0.0, "depth_total_b": 0.0,
                "depth_count_a": 0.0, "depth_count_b": 0.0,
                "umq_max_a": 0.0, "umq_max_b": 0.0,
                "match_ns_a": 0.0, "match_ns_b": 0.0,
            })
            r["depth_total_a"] += d.depth_mean[0] * d.depth_count[0]
            r["depth_total_b"] += d.depth_mean[1] * d.depth_count[1]
            r["depth_count_a"] += d.depth_count[0]
            r["depth_count_b"] += d.depth_count[1]
            r["umq_max_a"] = max(r["umq_max_a"], d.umq_len_max[0])
            r["umq_max_b"] = max(r["umq_max_b"], d.umq_len_max[1])
            r["match_ns_a"] += d.match_ns[0]
            r["match_ns_b"] += d.match_ns[1]
        return agg

    def flags(self, depth_factor: float = 4.0, depth_mean: float = 8.0,
              min_depth_samples: int = 32, umq_factor: float = 4.0,
              umq_len: float = 64.0) -> List[Finding]:
        """Findings for ranks where the candidate replay regressed past
        the thresholds (same kinds and thresholds style as the live
        ``long_traversal`` / ``umq_flood`` detectors; severity is the
        deterministic excess-traversal cost, not wall time, so flags are
        reproducible run to run)."""
        out: List[Finding] = []
        for rank, agg in sorted(self.per_rank().items()):
            mean_a = agg["depth_total_a"] / max(agg["depth_count_a"], 1.0)
            mean_b = agg["depth_total_b"] / max(agg["depth_count_b"], 1.0)
            if (agg["depth_count_b"] >= min_depth_samples
                    and mean_b >= depth_mean
                    and mean_b >= depth_factor * max(mean_a, 1.0)):
                excess = agg["depth_total_b"] - agg["depth_total_a"]
                out.append(Finding(
                    kind="long_traversal",
                    message=(
                        f"replayed {self.b_mode!r} traverses the PRQ "
                        f"{mean_b:.1f} deep vs {mean_a:.1f} on "
                        f"{self.a_mode!r} (rank {rank}, "
                        f"{int(agg['depth_count_b'])} matches, "
                        f"{(agg['match_ns_b'] - agg['match_ns_a']) / 1e6:+.3f}"
                        f" ms measured)"),
                    severity=excess * NS_PER_QUEUE_ENTRY / 1e9,
                ))
            if (agg["umq_max_b"] >= umq_len
                    and agg["umq_max_b"]
                    >= umq_factor * max(agg["umq_max_a"], 1.0)):
                out.append(Finding(
                    kind="umq_flood",
                    message=(
                        f"replayed {self.b_mode!r} grows the UMQ to "
                        f"{agg['umq_max_b']:.0f} vs {agg['umq_max_a']:.0f} "
                        f"on {self.a_mode!r} (rank {rank})"),
                    severity=(agg["umq_max_b"] - agg["umq_max_a"])
                    * NS_PER_QUEUE_ENTRY / 1e9,
                ))
        out.sort(key=lambda f: -f.severity)
        return out

    def to_report(self) -> ProfileReport:
        """The unified report: one row per (phase, rank) cell carrying
        measured match latency (seconds), findings from :meth:`flags`."""
        rows = [ReportRow(
            path=f"phase{d.index}:{d.label}/rank{d.rank}",
            baseline=d.match_ns[0] / 1e9,
            candidate=d.match_ns[1] / 1e9,
        ) for d in self.deltas]
        return ProfileReport(kind="trace", baseline_name=self.a_mode,
                             candidate_name=self.b_mode, rows=rows,
                             findings=self.flags())

    def report(self, limit: int = 12) -> str:
        worst = sorted(
            (d for d in self.deltas
             if d.depth_count[0] or d.depth_count[1]),
            key=lambda d: -(abs(d.latency_delta_s)
                            + abs(d.depth_mean[1] - d.depth_mean[0])))
        lines = [f"trace diff: {self.a_mode!r} -> {self.b_mode!r}, "
                 f"{len(self.deltas)} (phase, rank) cells"]
        lines += [str(d) for d in worst[:limit]]
        for f in self.flags():
            lines.append(str(f))
        return "\n".join(lines)


def diff(a: ReplayResult, b: ReplayResult,
         align: str = "index") -> TraceDiff:
    """Diff two replays phase-by-phase.

    ``align="index"`` (the default) zips phases positionally: replays
    of the same trace align exactly, and alignment stops at the first
    structural ``(op, label)`` mismatch — right for same-trace what-if
    comparisons.

    ``align="label"`` aligns *different runs* whose phase indices
    diverge (extra warmup rounds, a skipped collective, interleaved
    extra phases): the k-th occurrence of each ``(op, label)`` identity
    in ``a`` is paired with the k-th occurrence in ``b``, in ``a``'s
    order; unmatched phases on either side are left out of the diff
    rather than poisoning the cells after a divergence point. This is
    the cross-trace mode ``benchmarks/replay_sweep.py --align=label``
    surfaces."""
    deltas: List[PhaseDelta] = []
    if align == "index":
        for pa, pb in zip(a.phases, b.phases):
            if (pa.op, pa.label) != (pb.op, pb.label):
                break
            deltas.extend(_phase_deltas(pa, pb))
    elif align == "label":
        by_key: Dict[Tuple[str, str], List[PhaseStats]] = {}
        for pb in b.phases:
            by_key.setdefault((pb.op, pb.label), []).append(pb)
        taken: Dict[Tuple[str, str], int] = {}
        for pa in a.phases:
            key = (pa.op, pa.label)
            i = taken.get(key, 0)
            cands = by_key.get(key)
            if cands is None or i >= len(cands):
                continue
            taken[key] = i + 1
            deltas.extend(_phase_deltas(pa, cands[i]))
    else:
        raise ValueError(
            f"align must be 'index' or 'label', got {align!r}")
    return TraceDiff(a_mode=a.mode, b_mode=b.mode, deltas=deltas)
