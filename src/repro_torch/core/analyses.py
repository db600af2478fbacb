"""Automated analyses over profiling data (paper §4.1 and method 2).

The paper suggests four activities when reading a timeline; each is
implemented as a detector over a list of events:

  * large waits in synchronizing functions  -> :func:`large_waits`
  * thread contention in critical sections  -> :func:`contention`
  * irregular durations of one region       -> :func:`irregular`
  * large gaps between profiled regions     -> :func:`gaps`

Counter snapshots from the message-matching engine (method 2, serialized
as zero-duration ``category="counter"`` events) get two more detectors:

  * deep posted-receive-queue traversals    -> :func:`long_traversal`
  * runaway unexpected-message queue        -> :func:`umq_flood`

and four more for the transport-level fault classes
:mod:`repro.faults` injects (each derived from the same matching
counters, so they fire on production traces the same way they fire on
injected faults):

  * posted receives nothing ever matched    -> :func:`orphan_posts`
  * arrivals no receive ever claimed        -> :func:`duplicate_match`
  * displaced deliveries inflating UMQ digs -> :func:`reorder_inflation`
  * one rank starving or lagging its peers  -> :func:`straggler_rank`

Both group counter events by pid before testing thresholds; since a
:class:`repro_torch.match.Fabric` records one counter lane per rank, the
``min_samples`` / ``max_length`` defaults apply *per rank* — lower them
for small multi-rank runs whose per-rank sample counts are tiny.

Each returns a list of :class:`Finding`. ``analyze_all`` runs the suite —
this is what found the BlockingProgress-lock contention analog in our
serialized communication schedule (see benchmarks/fig_timeline.py), and
what flags the seeded matching-engine defects in
benchmarks/matching_sweep.py.

A copy of ``repro.core.analyses``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .counters import COUNTER_CATEGORY, CounterStat, counter_stats
from .events import Event


@dataclasses.dataclass
class Finding:
    kind: str                 # "large_wait" | "contention" | "irregular" |
                              # "gap" | "long_traversal" | "umq_flood" |
                              # "orphan_posts" | "duplicate_match" |
                              # "reorder_inflation" | "straggler_rank"
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


def _by_name(events: Sequence[Event]) -> Dict[str, List[Event]]:
    groups: Dict[str, List[Event]] = defaultdict(list)
    for ev in events:
        groups[ev.name].append(ev)
    return groups


def large_waits(
    events: Sequence[Event],
    categories: Tuple[str, ...] = ("collective",),
    factor: float = 3.0,
    min_duration_ns: int = 0,
) -> List[Finding]:
    """Occurrences of synchronizing regions that take >= factor x median of
    their own name — the 'large waits in barriers/reductions' check."""
    out: List[Finding] = []
    sync = [e for e in events if e.category in categories]
    for name, evs in _by_name(sync).items():
        if len(evs) < 2:
            continue
        med = statistics.median(e.duration for e in evs)
        if med <= 0:
            continue
        for ev in evs:
            if ev.duration >= factor * med and ev.duration >= min_duration_ns:
                out.append(
                    Finding(
                        kind="large_wait",
                        message=(
                            f"'{name}' (pid {ev.pid}, tid {ev.tid}) took "
                            f"{ev.duration / 1e6:.3f} ms vs median {med / 1e6:.3f} ms"
                        ),
                        severity=(ev.duration - med) / 1e9,
                        events=[ev],
                    )
                )
    out.sort(key=lambda f: -f.severity)
    return out


def contention(
    events: Sequence[Event],
    name_filter: Optional[str] = None,
    min_overlap_ns: int = 0,
) -> List[Finding]:
    """Same-named regions overlapping in time on *different threads* of the
    same pid — the BlockingProgress-lock pattern of paper Fig. 8. Regions
    tagged with attrs={'lock': ...} are always considered; otherwise any
    same-name cross-thread overlap is reported."""
    out: List[Finding] = []
    per_pid: Dict[int, List[Event]] = defaultdict(list)
    for ev in events:
        if name_filter is not None and name_filter not in ev.name:
            continue
        per_pid[ev.pid].append(ev)
    for pid, evs in per_pid.items():
        for name, group in _by_name(evs).items():
            group.sort(key=lambda e: e.t_start)
            active: List[Event] = []
            for ev in group:
                active = [a for a in active if a.t_end > ev.t_start]
                for a in active:
                    if a.tid == ev.tid:
                        continue
                    ov = a.overlaps(ev)
                    if ov > min_overlap_ns:
                        out.append(
                            Finding(
                                kind="contention",
                                message=(
                                    f"'{name}' contended between tid {a.tid} and "
                                    f"tid {ev.tid} on pid {pid} for {ov / 1e6:.3f} ms"
                                ),
                                severity=ov / 1e9,
                                events=[a, ev],
                                pid=pid,
                            )
                        )
                active.append(ev)
    out.sort(key=lambda f: -f.severity)
    return out


def irregular(
    events: Sequence[Event],
    factor: float = 3.0,
    min_occurrences: int = 4,
) -> List[Finding]:
    """Occurrences irregular in duration relative to other occurrences of
    the same region (any category)."""
    out: List[Finding] = []
    for name, evs in _by_name(events).items():
        if len(evs) < min_occurrences:
            continue
        med = statistics.median(e.duration for e in evs)
        if med <= 0:
            continue
        for ev in evs:
            if ev.duration >= factor * med:
                out.append(
                    Finding(
                        kind="irregular",
                        message=(
                            f"'{name}' occurrence at {ev.t_start / 1e6:.3f} ms is "
                            f"{ev.duration / med:.1f}x its median duration"
                        ),
                        severity=(ev.duration - med) / 1e9,
                        events=[ev],
                    )
                )
    out.sort(key=lambda f: -f.severity)
    return out


def gaps(
    events: Sequence[Event],
    min_gap_ns: int = 1_000_000,
    leaf_only: bool = True,
) -> List[Finding]:
    """Large gaps between consecutive profiled regions on one (pid, tid)."""
    out: List[Finding] = []
    lanes: Dict[Tuple[int, int], List[Event]] = defaultdict(list)
    for ev in events:
        if ev.category == COUNTER_CATEGORY:
            continue              # instant counter samples are not regions
        lanes[(ev.pid, ev.tid)].append(ev)
    for (pid, tid), evs in lanes.items():
        if leaf_only:
            # keep only events that contain no other event (innermost regions)
            evs = [
                e
                for e in evs
                if not any(
                    o is not e and o.t_start >= e.t_start and o.t_end <= e.t_end
                    for o in evs
                )
            ]
        evs.sort(key=lambda e: e.t_start)
        for prev, nxt in zip(evs, evs[1:]):
            gap = nxt.t_start - prev.t_end
            if gap >= min_gap_ns:
                out.append(
                    Finding(
                        kind="gap",
                        message=(
                            f"{gap / 1e6:.3f} ms unprofiled gap between "
                            f"'{prev.name}' and '{nxt.name}' on pid {pid} tid {tid}"
                        ),
                        severity=gap / 1e9,
                        events=[prev, nxt],
                    )
                )
    out.sort(key=lambda f: -f.severity)
    return out


def _counter_events_by_pid(
    events: Sequence[Event],
) -> Dict[int, List[Event]]:
    per_pid: Dict[int, List[Event]] = defaultdict(list)
    for ev in events:
        if ev.category == COUNTER_CATEGORY:
            per_pid[ev.pid].append(ev)
    return per_pid


# Nominal cost of touching one queue entry, used to turn excess traversal
# depth into suspect seconds when no measured search time is available.
NS_PER_QUEUE_ENTRY = 100.0


def _long_traversal_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    mean_depth: float,
    min_samples: int,
) -> Optional[Finding]:
    """Threshold test over one pid's counter stats; shared by the post-hoc
    event detector and the live telemetry bridge so both surface identical
    findings from the same lane statistics."""
    depth = stats.get("match.prq.traversal_depth")
    if depth is None or depth.count < min_samples:
        return None
    if depth.mean < mean_depth:
        return None
    search = stats.get("match.prq.search_ns")
    suspect_ns = (search.total if search is not None
                  else (depth.total - depth.count) * NS_PER_QUEUE_ENTRY)
    return Finding(
        kind="long_traversal",
        message=(
            f"PRQ traversal depth mean {depth.mean:.1f} "
            f"(max {depth.vmax:.0f}) over {depth.count} matches on "
            f"pid {pid} — posted-receive queue is searched linearly"
        ),
        severity=suspect_ns / 1e9,
        pid=pid,
    )


def _umq_flood_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    max_length: float,
    mean_length: float,
) -> Optional[Finding]:
    length = stats.get("match.umq.length")
    if length is None or length.count == 0:
        return None
    if length.vmax < max_length or length.mean < mean_length:
        return None
    leaked = stats.get("match.umq.leaked")
    search = stats.get("match.umq.search_ns")
    suspect_ns = (search.total if search is not None
                  else length.total * NS_PER_QUEUE_ENTRY)
    detail = (f", {leaked.total:.0f} entries leaked"
              if leaked is not None and leaked.total else "")
    return Finding(
        kind="umq_flood",
        message=(
            f"UMQ length mean {length.mean:.1f} grew to "
            f"{length.vmax:.0f} on pid {pid} — unexpected-message "
            f"queue is not reclaimed{detail}"
        ),
        severity=suspect_ns / 1e9,
        pid=pid,
    )


def long_traversal(
    events: Sequence[Event],
    mean_depth: float = 8.0,
    min_samples: int = 32,
) -> List[Finding]:
    """Posted-receive-queue traversals far deeper than a binned engine's
    O(1) — the linear-search defect (method 2). Reads the
    ``match.prq.traversal_depth`` histogram out of counter snapshots."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _long_traversal_finding(pid, counter_stats(evs),
                                    mean_depth, min_samples)
        if f is not None:
            f.events = [e for e in evs
                        if e.name == "counter/match.prq.traversal_depth"]
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def long_traversal_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    mean_depth: float = 8.0,
    min_samples: int = 32,
) -> List[Finding]:
    """:func:`long_traversal` directly over per-pid lane statistics
    (``CounterRegistry.snapshot_lanes`` shape) — no event
    materialization, so the live bridge can run it every poll."""
    out = [f for pid in sorted(lanes)
           for f in (_long_traversal_finding(pid, lanes[pid],
                                             mean_depth, min_samples),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


def umq_flood(
    events: Sequence[Event],
    max_length: float = 64.0,
    mean_length: float = 8.0,
) -> List[Finding]:
    """Unexpected-message queue that grows without bound — the
    never-garbage-collected-UMQ defect (method 2). Reads the
    ``match.umq.length`` histogram out of counter snapshots."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _umq_flood_finding(pid, counter_stats(evs),
                               max_length, mean_length)
        if f is not None:
            f.events = [e for e in evs
                        if e.name == "counter/match.umq.length"]
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def umq_flood_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    max_length: float = 64.0,
    mean_length: float = 8.0,
) -> List[Finding]:
    """:func:`umq_flood` directly over per-pid lane statistics."""
    out = [f for pid in sorted(lanes)
           for f in (_umq_flood_finding(pid, lanes[pid],
                                        max_length, mean_length),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


# -- fault-class detectors (repro.faults) --------------------------------
#
# All four run off the matching-counter algebra of one finished (or
# cumulative) run. The invariants they test hold exactly at run end for
# every balanced workload:
#
#   posts   = match.umq.traversal_depth.count   (every post observes it)
#   arrivals= match.prq.traversal_depth.count   (every arrival observes it)
#   posts   = match.umq.hit + match.prq parks, and every park is
#             eventually matched by an arrival (match.expected) — so
#             orphans  = posts - umq.hit - expected  is 0 when healthy;
#   arrivals= match.expected + match.unexpected, and every unexpected
#             park is eventually consumed by a post (match.umq.hit) — so
#             residue  = unexpected - umq.hit        is 0 when healthy.
#
# Dropped deliveries push ``orphans`` positive (a posted receive whose
# message vanished stalls forever); duplicated deliveries push
# ``residue`` positive (the second copy parks with no post left to
# claim it). Wildcard cross-matches push *both* up by the same amount
# on the same lane, so each detector thresholds its imbalance net of
# the other. Note the incremental ``_lanes`` variants see *in-flight*
# posts/parks as nonzero orphans/residue mid-run — the live bridge
# treats them as leading indicators, the post-hoc gate runs at
# end-of-run where the algebra is exact.


def _orphan_residue(stats: Dict[str, "CounterStat"]
                    ) -> Tuple[float, float]:
    """Per-lane end-of-run imbalances: (unmatched posted receives,
    unclaimed parked arrivals). A wildcard receive that cross-matches a
    message intended for a specific post leaves *one of each* on the
    same lane, so the two detectors below judge the net difference —
    the paired wildcard noise cancels while real drops (pure orphans)
    and real duplicates (pure residue) survive."""
    posts = stats.get("match.umq.traversal_depth")
    hits = stats.get("match.umq.hit")
    exp = stats.get("match.expected")
    unexp = stats.get("match.unexpected")
    n_posts = posts.count if posts is not None else 0
    n_hits = hits.total if hits is not None else 0
    orphans = n_posts - n_hits - (exp.total if exp is not None else 0)
    residue = (unexp.total if unexp is not None else 0) - n_hits
    return orphans, residue


def _orphan_posts_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    min_orphans: int,
    min_frac: float,
) -> Optional[Finding]:
    posts = stats.get("match.umq.traversal_depth")
    if posts is None or posts.count == 0:
        return None
    orphans, residue = _orphan_residue(stats)
    net = orphans - max(residue, 0)
    if net < min_orphans or net < min_frac * posts.count:
        return None
    return Finding(
        kind="orphan_posts",
        message=(
            f"{net:.0f} of {posts.count} posted receives on pid "
            f"{pid} never matched any arrival — deliveries dropped or "
            f"sender gone"
        ),
        severity=net * NS_PER_QUEUE_ENTRY / 1e9,
        pid=pid,
    )


def _duplicate_match_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    min_residue: int,
    min_frac: float,
) -> Optional[Finding]:
    arrivals = stats.get("match.prq.traversal_depth")
    if arrivals is None or arrivals.count == 0:
        return None
    orphans, residue = _orphan_residue(stats)
    net = residue - max(orphans, 0)
    if net < min_residue or net < min_frac * arrivals.count:
        return None
    return Finding(
        kind="duplicate_match",
        message=(
            f"{net:.0f} of {arrivals.count} arrivals on pid {pid} "
            f"parked unexpected and were never claimed by a receive — "
            f"deliveries duplicated"
        ),
        severity=net * NS_PER_QUEUE_ENTRY / 1e9,
        pid=pid,
    )


def _reorder_inflation_findings(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_bin: int,
    min_hits: int,
    min_frac: float,
) -> List[Finding]:
    # Cross-lane by construction: displaced delivery is a transport
    # property — traffic that rotates its fan-in target (a moving hot
    # shard) spreads the depth tail thinly over many ranks, so the
    # thresholds apply to the run-wide histogram, with the deepest lane
    # named for attribution.
    count = tail = 0
    excess = 0.0
    vmax = 0.0
    worst_pid, worst_tail = -1, -1
    for pid in sorted(lanes):
        stats = lanes[pid]
        leaked = stats.get("match.umq.leaked")
        if leaked is not None and leaked.total:
            # tombstone-inflated depths are umq_flood's story
            return []
        depth = stats.get("match.umq.traversal_depth")
        if depth is None or depth.count == 0:
            continue
        count += depth.count
        excess += depth.total - depth.count
        vmax = max(vmax, depth.vmax)
        t = sum(c for b, c in depth.bins.items() if b >= min_bin)
        tail += t
        if t > worst_tail:
            worst_pid, worst_tail = pid, t
    if count == 0 or tail < min_hits or tail < min_frac * count:
        return []
    return [Finding(
        kind="reorder_inflation",
        message=(
            f"{tail} of {count} UMQ searches dug >= {min_bin} entries "
            f"deep (max {vmax:.0f}, deepest on pid {worst_pid}) — "
            f"deliveries arriving far out of post order"
        ),
        severity=excess * NS_PER_QUEUE_ENTRY / 1e9,
        pid=worst_pid,
    )]


def _lane_ops(stats: Dict[str, "CounterStat"]) -> int:
    posts = stats.get("match.umq.traversal_depth")
    arrivals = stats.get("match.prq.traversal_depth")
    return ((posts.count if posts is not None else 0)
            + (arrivals.count if arrivals is not None else 0))


def _straggler_findings(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    skew_frac: float,
    min_ops: int,
    min_lanes: int,
    min_deferred: int,
) -> List[Finding]:
    """Two straggler signals over the whole lane set: direct evidence
    (``fault.delay.deferred`` — the injector's count of this rank's
    held-back deliveries, the live-run analog of a NIC backing off) and
    participation skew (a lane doing a small fraction of the median
    lane's matching ops: a rank that died, joined late, or is starved).
    """
    out: List[Finding] = []
    ops: Dict[int, int] = {}
    flagged = set()
    for pid in sorted(lanes):
        stats = lanes[pid]
        ops[pid] = _lane_ops(stats)
        deferred = stats.get("fault.delay.deferred")
        if deferred is not None and deferred.total >= min_deferred:
            flagged.add(pid)
            out.append(Finding(
                kind="straggler_rank",
                message=(
                    f"{deferred.total:.0f} deliveries from pid {pid} "
                    f"were held back in flight — straggling sender"
                ),
                severity=deferred.total * NS_PER_QUEUE_ENTRY / 1e9,
                pid=pid,
            ))
    if len(ops) >= min_lanes:
        med = statistics.median(ops.values())
        if med >= min_ops:
            for pid, n in sorted(ops.items()):
                if pid in flagged or n >= skew_frac * med:
                    continue
                out.append(Finding(
                    kind="straggler_rank",
                    message=(
                        f"pid {pid} did {n} matching ops vs a median of "
                        f"{med:.0f} across {len(ops)} lanes — rank left, "
                        f"joined late, or is starved"
                    ),
                    severity=(med - n) * NS_PER_QUEUE_ENTRY / 1e9,
                    pid=pid,
                ))
    out.sort(key=lambda f: -f.severity)
    return out


def orphan_posts(
    events: Sequence[Event],
    min_orphans: int = 4,
    min_frac: float = 0.02,
) -> List[Finding]:
    """Posted receives that no arrival ever matched (per rank) — the
    dropped-delivery / dead-sender fault class. Exact at end of run;
    see the invariant notes above."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _orphan_posts_finding(pid, counter_stats(evs),
                                  min_orphans, min_frac)
        if f is not None:
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def orphan_posts_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_orphans: int = 4,
    min_frac: float = 0.02,
) -> List[Finding]:
    """:func:`orphan_posts` directly over per-pid lane statistics."""
    out = [f for pid in sorted(lanes)
           for f in (_orphan_posts_finding(pid, lanes[pid],
                                           min_orphans, min_frac),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


def duplicate_match(
    events: Sequence[Event],
    min_residue: int = 4,
    min_frac: float = 0.02,
) -> List[Finding]:
    """Unexpected arrivals that no receive ever claimed (per rank) —
    the duplicated-delivery fault class."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _duplicate_match_finding(pid, counter_stats(evs),
                                     min_residue, min_frac)
        if f is not None:
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def duplicate_match_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_residue: int = 4,
    min_frac: float = 0.02,
) -> List[Finding]:
    """:func:`duplicate_match` directly over per-pid lane statistics."""
    out = [f for pid in sorted(lanes)
           for f in (_duplicate_match_finding(pid, lanes[pid],
                                              min_residue, min_frac),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


def reorder_inflation(
    events: Sequence[Event],
    min_bin: int = 8,
    min_hits: int = 8,
    min_frac: float = 0.02,
) -> List[Finding]:
    """UMQ searches digging far deeper than healthy delivery order
    allows — the displaced-delivery fault class. Reads the power-of-two
    tail of the run-wide ``match.umq.traversal_depth`` histogram
    (cross-lane, so rotating fan-in targets still accumulate one tail);
    runs with leaked (tombstoned) UMQ entries are skipped, since their
    depth inflation belongs to :func:`umq_flood`."""
    lanes = {pid: counter_stats(evs)
             for pid, evs in _counter_events_by_pid(events).items()}
    return _reorder_inflation_findings(lanes, min_bin, min_hits,
                                       min_frac)


def reorder_inflation_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_bin: int = 8,
    min_hits: int = 8,
    min_frac: float = 0.02,
) -> List[Finding]:
    """:func:`reorder_inflation` directly over per-pid lane stats."""
    return _reorder_inflation_findings(lanes, min_bin, min_hits,
                                       min_frac)


def straggler_rank(
    events: Sequence[Event],
    skew_frac: float = 0.25,
    min_ops: int = 32,
    min_lanes: int = 3,
    min_deferred: int = 4,
) -> List[Finding]:
    """One rank lagging or starving its peers — the straggler / elastic
    (leave/join) fault class. Cross-lane by construction: the skew test
    compares each lane's matching-op count against the median lane."""
    lanes = {pid: counter_stats(evs)
             for pid, evs in _counter_events_by_pid(events).items()}
    return _straggler_findings(lanes, skew_frac, min_ops, min_lanes,
                               min_deferred)


def straggler_rank_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    skew_frac: float = 0.25,
    min_ops: int = 32,
    min_lanes: int = 3,
    min_deferred: int = 4,
) -> List[Finding]:
    """:func:`straggler_rank` directly over per-pid lane statistics."""
    return _straggler_findings(lanes, skew_frac, min_ops, min_lanes,
                               min_deferred)


# -- self-healing evidence (repro.faults.recovery) ---------------------
# Successful recovery nets the orphan/residue algebra above back to
# zero — a healed run is indistinguishable from a healthy one in the
# matching counters. These detectors therefore key on the evidence
# counters the recovery layer records on the affected lanes:
#
#   fault.recovery.retransmit — dropped deliveries healed by a modeled
#     retransmit (counted on the receiver's lane at redelivery)
#   fault.recovery.retry      — retransmits that were lost again and
#     rescheduled with exponential backoff
#   fault.recovery.suppressed — duplicate deliveries discarded by the
#     receiver's sequence-number window before reaching the engine
#   fault.recovery.cancelled  — receives never posted because their
#     sender was known dead (rank_leave orphan-post cancellation)


def _recovered_drop_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    min_recovered: int,
) -> Optional[Finding]:
    rtx = stats.get("fault.recovery.retransmit")
    can = stats.get("fault.recovery.cancelled")
    n_rtx = rtx.total if rtx is not None else 0
    n_can = can.total if can is not None else 0
    total = n_rtx + n_can
    if total < min_recovered:
        return None
    detail = (f" and {n_can:.0f} doomed receives cancelled"
              if n_can else "")
    return Finding(
        kind="recovered_drop",
        message=(
            f"{n_rtx:.0f} dropped deliveries to pid {pid} were "
            f"retransmitted{detail} — transport healed message loss"
        ),
        severity=total * NS_PER_QUEUE_ENTRY / 1e9,
        pid=pid,
    )


def _suppressed_duplicate_finding(
    pid: int,
    stats: Dict[str, "CounterStat"],
    min_suppressed: int,
) -> Optional[Finding]:
    sup = stats.get("fault.recovery.suppressed")
    if sup is None or sup.total < min_suppressed:
        return None
    return Finding(
        kind="suppressed_duplicate",
        message=(
            f"{sup.total:.0f} duplicate deliveries to pid {pid} were "
            f"discarded by the sequence-number window before parking "
            f"on the UMQ"
        ),
        severity=sup.total * NS_PER_QUEUE_ENTRY / 1e9,
        pid=pid,
    )


def _retry_storm_findings(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_retries: int,
    storm_frac: float,
) -> List[Finding]:
    # Cross-lane by construction: a storm is a transport property —
    # retries amplify load on the whole fabric, so the threshold is a
    # run-wide retry:redelivery ratio, with the worst lane named.
    retries = redelivered = 0.0
    worst_pid, worst_n = -1, -1.0
    for pid in sorted(lanes):
        stats = lanes[pid]
        r = stats.get("fault.recovery.retry")
        t = stats.get("fault.recovery.retransmit")
        n = r.total if r is not None else 0
        retries += n
        redelivered += t.total if t is not None else 0
        if n > worst_n:
            worst_pid, worst_n = pid, n
    if retries < min_retries or retries < storm_frac * max(redelivered, 1):
        return []
    return [Finding(
        kind="retry_storm",
        message=(
            f"{retries:.0f} retransmissions were lost and retried "
            f"against {redelivered:.0f} successful redeliveries "
            f"(worst lane pid {worst_pid}) — recovery is amplifying "
            f"load instead of healing it"
        ),
        severity=retries * NS_PER_QUEUE_ENTRY / 1e9,
        pid=worst_pid,
    )]


def recovered_drop(
    events: Sequence[Event],
    min_recovered: int = 4,
) -> List[Finding]:
    """Dropped deliveries the recovery layer healed (retransmits plus
    cancelled doomed posts, per rank) — proof the run absorbed message
    loss without orphaning receives."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _recovered_drop_finding(pid, counter_stats(evs),
                                    min_recovered)
        if f is not None:
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def recovered_drop_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_recovered: int = 4,
) -> List[Finding]:
    """:func:`recovered_drop` directly over per-pid lane statistics."""
    out = [f for pid in sorted(lanes)
           for f in (_recovered_drop_finding(pid, lanes[pid],
                                             min_recovered),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


def suppressed_duplicate(
    events: Sequence[Event],
    min_suppressed: int = 4,
) -> List[Finding]:
    """Duplicate deliveries the receiver's sequence-number window
    discarded (per rank) — the healed counterpart of
    :func:`duplicate_match`."""
    out: List[Finding] = []
    for pid, evs in _counter_events_by_pid(events).items():
        f = _suppressed_duplicate_finding(pid, counter_stats(evs),
                                          min_suppressed)
        if f is not None:
            out.append(f)
    out.sort(key=lambda f: -f.severity)
    return out


def suppressed_duplicate_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_suppressed: int = 4,
) -> List[Finding]:
    """:func:`suppressed_duplicate` directly over per-pid lane stats."""
    out = [f for pid in sorted(lanes)
           for f in (_suppressed_duplicate_finding(pid, lanes[pid],
                                                   min_suppressed),)
           if f is not None]
    out.sort(key=lambda f: -f.severity)
    return out


def retry_storm(
    events: Sequence[Event],
    min_retries: int = 8,
    storm_frac: float = 1.0,
) -> List[Finding]:
    """Recovery retries outnumbering successful redeliveries — bounded
    retransmission degenerating into load amplification (run-wide, with
    the worst lane named)."""
    lanes = {pid: counter_stats(evs)
             for pid, evs in _counter_events_by_pid(events).items()}
    return _retry_storm_findings(lanes, min_retries, storm_frac)


def retry_storm_lanes(
    lanes: Dict[int, Dict[str, "CounterStat"]],
    min_retries: int = 8,
    storm_frac: float = 1.0,
) -> List[Finding]:
    """:func:`retry_storm` directly over per-pid lane statistics."""
    return _retry_storm_findings(lanes, min_retries, storm_frac)


def analyze_all(events: Sequence[Event], **kwargs) -> List[Finding]:
    out: List[Finding] = []
    out.extend(large_waits(events))
    out.extend(contention(events))
    out.extend(irregular(events))
    out.extend(gaps(events, min_gap_ns=kwargs.get("min_gap_ns", 1_000_000)))
    out.extend(long_traversal(events))
    out.extend(umq_flood(events))
    out.extend(orphan_posts(events))
    out.extend(duplicate_match(events))
    out.extend(reorder_inflation(events))
    out.extend(straggler_rank(events))
    out.extend(recovered_drop(events))
    out.extend(suppressed_duplicate(events))
    out.extend(retry_storm(events))
    out.sort(key=lambda f: -f.severity)
    return out


def report(findings: Sequence[Finding], limit: int = 20) -> str:
    lines = [f"{len(findings)} findings"]
    lines += [str(f) for f in findings[:limit]]
    return "\n".join(lines)
