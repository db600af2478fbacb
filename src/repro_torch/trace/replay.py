"""Deterministic what-if replay of recorded communication traces.

A recorded trace is an ordered stream of matching-engine operations
(post/arrive with envelopes), phase markers and progress-engine lane
events. Replay re-drives that exact stream through a *fresh* set of
engines in any mode (``binned``/``fifo``, ``linear``, ``leaky_umq``) —
no device, no re-execution of the workload — and produces the same
artifacts a live run produces:

  * per-rank, per-phase counter statistics (one registry lane per rank),
  * ``core.counters`` snapshot Events (category ``"counter"``) at every
    phase boundary, so ``long_traversal`` / ``umq_flood`` and the rest of
    :mod:`repro_torch.core.analyses` run on replayed data unchanged,
  * modeled progress-engine lock Events under either queue discipline
    (the §4 shared-queue defect vs the incoming-queue fix), so
    ``contention`` runs on replayed data too.

Because the seeded defects change *cost*, never *matching* (the
engine-mode equivalence property ``tests/test_match.py`` pins down),
replaying under a different mode answers "what would this exact run have
cost on that engine?" — and replaying under the same mode reproduces the
recorded match order exactly (``divergences`` stays empty).

Two execution paths share one result type:

  * ``check_matches=True`` (the default) — per-op dispatch with match-
    order verification: every recorded outcome is compared against the
    replayed one and ``matches``/``divergences`` are populated. This is
    the soundness path the acceptance sweeps gate.
  * ``check_matches=False`` — the **batched streaming** path (the trace-
    pipeline overhaul): records stream straight off the reader, v3
    chunks are decoded column-wise into flat per-rank op streams and
    dispatched through :meth:`repro_torch.match.MatchEngine.run_ops` at every
    phase boundary (one python call per rank per phase, the
    columnar counter sink underneath), so the full record list is never
    materialized and per-op python dispatch disappears. Counter
    statistics, phases and findings are identical — pinned against the
    frozen pre-overhaul replayer (:mod:`repro_torch.trace.legacy_replay`) by
    ``benchmarks/replay_bench.py``, which also gates the >= 5x
    throughput this path exists for.

A copy of ``repro.trace.replay``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from itertools import accumulate, repeat
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from ..core.counters import CounterRegistry, CounterStat, counter_stats
from ..core.events import Event
from ..match import MatchEngine, canonical_mode
from .io import TraceReader, iter_trace
from .schema import (REC_ARRIVE, REC_CHUNK, REC_PE_CHUNK, REC_PHASE,
                     REC_POST, REC_PROGRESS, REC_SNAPSHOT, decode_chunk,
                     decode_flags, decode_pe_chunk)

# mirrors repro_torch.comm.progress.LOCK_REGION without importing the comm
# layer (which would pull in torch — replay stays device-free)
LOCK_REGION = "BlockingProgress lock"

# synthetic spacing between phase snapshots on the replay timeline
PHASE_NS = 1_000_000


@dataclasses.dataclass
class PhaseStats:
    """Counter deltas attributed to one recorded phase, per rank.

    ``wall_ns`` is the measured live wall-clock span of the phase's
    recorded ops (schema v2+ ``t_wall`` stamps); ``None`` for v1 traces
    or deterministic-mode recordings."""

    index: int
    label: str
    op: str
    attrs: Dict = dataclasses.field(default_factory=dict)
    stats: Dict[int, Dict[str, CounterStat]] = dataclasses.field(
        default_factory=dict)
    wall_ns: Optional[int] = None

    def metric(self, rank: int, name: str) -> Optional[CounterStat]:
        return self.stats.get(rank, {}).get(name)


class ReplayResult:
    """Everything one replay produced. ``events`` (the counter snapshot
    Events plus modeled progress-lane Events the detectors consume) is
    **materialized lazily** from the per-phase lane statistics: the
    batched streaming path never pays the Event + attrs encode cost for
    consumers that only read ``phases`` (the differ, the bench gates) —
    accessing ``.events`` builds the identical event list the eager
    per-op path would have produced."""

    def __init__(self, mode: str, progress_mode: Optional[str],
                 header: Dict,
                 matches: List[Tuple[int, str, int, Optional[int]]],
                 divergences: List[Dict], phases: List[PhaseStats],
                 registry: CounterRegistry,
                 events: Optional[List[Event]] = None,
                 progress_events: Optional[List[Event]] = None,
                 pe_records: Optional[List[Dict]] = None,
                 recorded_stats: Optional[
                     Dict[int, Dict[str, CounterStat]]] = None,
                 raw_snap: Optional[Dict] = None,
                 n_ops: int = 0, phase_ns: int = PHASE_NS,
                 skipped_records: Optional[Dict[str, int]] = None):
        self.mode = mode
        self.progress_mode = progress_mode
        self.header = header
        self.matches = matches
        self.divergences = divergences
        self.phases = phases
        self.registry = registry
        # per-category tally of corrupt source lines a lenient
        # (strict=False) reader dropped before replay saw them
        self.skipped_records: Dict[str, int] = skipped_records or {}
        # engine ops replayed; on the batched path (check_matches=False)
        # ``matches`` stays empty, so this is the op count to report
        self.n_ops = n_ops
        self.phase_ns = phase_ns
        self._events = events
        self._pe_records = pe_records or []
        # eager results pass the modeled progress events in (they are
        # also inside `events` already); lazy ones model them on demand
        # from the pe records
        self._progress_events: Optional[List[Event]] = (
            (progress_events or []) if events is not None else None)
        self._recorded_stats = recorded_stats
        self._raw_snap = raw_snap

    @property
    def recorded_stats(self) -> Optional[
            Dict[int, Dict[str, CounterStat]]]:
        """The record-time final counter snapshot (the trace's ``snap``
        record), parsed on first access."""
        if self._recorded_stats is None and self._raw_snap is not None:
            self._recorded_stats = _parse_snap(self._raw_snap)
            self._raw_snap = None
        return self._recorded_stats

    @property
    def pe_records(self) -> List[Dict]:
        """The recorded progress-engine lane records (expanded), as fed
        to :func:`replay_progress` — the transportable form sharded
        replay merges across workers."""
        return self._pe_records

    @property
    def raw_snapshot(self) -> Optional[Dict]:
        """The unparsed final ``snap`` record, if the trace carried one
        and :attr:`recorded_stats` has not consumed it yet."""
        return self._raw_snap

    @property
    def progress_events(self) -> List[Event]:
        """Modeled progress-engine lock Events (lazy: the queue model
        only runs when something consumes the events)."""
        ev = self._progress_events
        if ev is None:
            ev = self._progress_events = (
                replay_progress(self._pe_records, self.progress_mode)
                if self._pe_records and self.progress_mode else [])
        return ev

    @property
    def events(self) -> List[Event]:
        ev = self._events
        if ev is None:
            ev = self._events = (self._phase_events()
                                 + self.progress_events)
        return ev

    def _phase_events(self) -> List[Event]:
        """Counter snapshot Events rebuilt from the per-phase lane stats
        (same names, paths, timestamps, attrs and ordering as
        :meth:`repro_torch.core.counters.CounterRegistry.snapshot_events` at
        every phase flush)."""
        from ..core.counters import COUNTER_CATEGORY, COUNTER_PREFIX
        out: List[Event] = []
        for phase in self.phases:
            t = (phase.index + 1) * self.phase_ns
            for pid in sorted(phase.stats):
                per = phase.stats[pid]
                for name in sorted(per):
                    attrs = per[name].to_attrs()
                    attrs["phase"] = phase.label
                    attrs["phase_index"] = phase.index
                    out.append(Event(
                        name=COUNTER_PREFIX + name,
                        path=("counters",) + tuple(name.split(".")),
                        category=COUNTER_CATEGORY, t_start=t, t_end=t,
                        pid=pid, tid=0, attrs=attrs))
        return out

    def totals(self) -> Dict[str, CounterStat]:
        """Replayed counter statistics aggregated across ranks."""
        return counter_stats(self.events)

    def measured_wall_s(self) -> Optional[float]:
        """Total measured live wall time across phases (v2+ ``t_wall``
        stamps), or ``None`` when the trace carries no timing (v1, or
        recorded in deterministic mode)."""
        spans = [p.wall_ns for p in self.phases if p.wall_ns is not None]
        return sum(spans) / 1e9 if spans else None

    def dilation(self, baseline: "ReplayResult") -> Optional[float]:
        """Measured wall-time dilation of this trace's live run relative
        to ``baseline``'s (e.g. a defective recording vs a healthy one).
        ``None`` unless both traces carry ``t_wall`` timing."""
        a, b = baseline.measured_wall_s(), self.measured_wall_s()
        if a is None or b is None or a <= 0:
            return None
        return b / a

    def totals_by_rank(self) -> Dict[int, Dict[str, CounterStat]]:
        per: Dict[int, List[Event]] = {}
        for ev in self.events:
            per.setdefault(ev.pid, []).append(ev)
        return {pid: counter_stats(evs) for pid, evs in per.items()}


def _parse_snap(rec: Dict) -> Dict[int, Dict[str, CounterStat]]:
    out: Dict[int, Dict[str, CounterStat]] = {}
    for pid, per in rec["stats"].items():
        out[int(pid)] = {name: CounterStat.from_attrs(attrs)
                         for name, attrs in per.items()}
    return out


def _expand_stream(records: Iterable[Dict]) -> Iterable[Dict]:
    """Expand v3 chunks inline (threading the per-rank derived-seq
    counters) so the per-op verification path sees the per-op record
    stream regardless of how the source was read."""
    seqs: Dict[int, int] = {}
    for rec in records:
        kind = rec.get("t")
        if kind == REC_CHUNK:
            yield from decode_chunk(rec, seqs)
            continue
        if kind == REC_PE_CHUNK:
            yield from decode_pe_chunk(rec)
            continue
        if kind == REC_POST or kind == REC_ARRIVE:
            rank, seq = rec.get("rank"), rec.get("seq")
            if type(rank) is int and type(seq) is int:
                seqs[rank] = seq + 1
        yield rec


def replay_progress(pe_records: Sequence[Dict], mode: str = "incoming",
                    pid: int = 0, swap_ns: int = 1_000) -> List[Event]:
    """Re-model recorded progress-engine lane events under a queue
    discipline (deterministic queueing model over the recorded submit
    times and processing quanta):

      * ``"shared"`` — one queue: the progress thread holds the lock for
        whole processing quanta, so a submit landing inside a busy span
        waits for the span to end. Lock-hold Events overlap across
        threads, which ``core.analyses.contention`` flags — the paper's
        Fig. 8, reconstructed offline.
      * ``"incoming"`` — second queue: the lock is held only for an O(1)
        append/swap; lock Events never overlap and the timeline is clean.

    tid 0 is the user thread, tid 1 the progress thread (the same lane
    convention as the live timeline)."""
    assert mode in ("shared", "incoming")
    # concurrent submitters can win the trace-writer lock out of enqueue
    # order; ts is captured pre-lock, so sorting restores arrival order
    # before submits are paired positionally with FIFO-processed quanta
    submits = sorted((r for r in pe_records if r.get("ev") == "submit"),
                     key=lambda r: r["ts"])
    procs = sorted((r for r in pe_records if r.get("ev") == "proc"),
                   key=lambda r: r["ts"])
    if not submits or not procs:
        return []
    base = min(r["ts"] for r in submits + procs)
    events: List[Event] = []

    def lock_event(tid: int, t0: int, t1: int) -> Event:
        return Event(name=LOCK_REGION, path=("replay", LOCK_REGION),
                     category="runtime", t_start=t0, t_end=t1, pid=pid,
                     tid=tid, attrs={"lock": "request_queue",
                                     "replayed": mode})

    if mode == "shared":
        # progress thread drains back-to-back, holding the lock for whole
        # processing quanta; request i completes at C_i
        spans: List[Tuple[int, int]] = []
        completions: List[int] = []
        frontier: Optional[int] = None
        for sub, proc in zip(submits, procs):
            s = sub["ts"] - base
            start = s if frontier is None or frontier <= s else frontier
            end = start + int(proc.get("dur", 0))
            events.append(Event(
                name="progress/process", path=("replay", "progress",
                                               "process"),
                category="runtime", t_start=start, t_end=end, pid=pid,
                tid=1))
            spans.append((start, end))
            completions.append(end)
            frontier = end
        merged: List[Tuple[int, int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        for a, b in merged:
            events.append(lock_event(1, a, b))
        # submit j blocks behind the processing of every *earlier*
        # request (the paper's Fig. 10: Isend latency grows with the
        # number of pending requests). Submits without a matching proc
        # record (engine shut down with requests still queued) block
        # behind the last *known* completion.
        for j, sub in enumerate(submits):
            s = sub["ts"] - base
            release = s + swap_ns
            if j > 0 and completions:
                release = max(release,
                              completions[min(j, len(completions)) - 1])
            events.append(lock_event(0, s, release))
    else:
        frontier = 0
        for sub, proc in zip(submits, procs):
            s = sub["ts"] - base
            events.append(lock_event(0, s, s + swap_ns))
            # instant swap on the progress thread: zero-width hold, no
            # cross-thread overlap possible
            events.append(lock_event(1, s + swap_ns, s + swap_ns))
            start = max(s + swap_ns, frontier)
            end = start + int(proc.get("dur", 0))
            events.append(Event(
                name="progress/process", path=("replay", "progress",
                                               "process"),
                category="runtime", t_start=start, t_end=end, pid=pid,
                tid=1))
            frontier = end
    events.sort(key=lambda e: (e.t_start, e.t_end))
    return events


@dataclasses.dataclass
class PartitionScan:
    """Cheap pre-scan of a trace for shard planning (no replay, no chunk
    expansion): which ranks appear and how many ops each carries, how
    many phases the stream is cut into, and the total op count."""

    header: Dict
    rank_ops: Dict[int, int]
    n_phases: int
    n_ops: int

    @property
    def ranks(self) -> List[int]:
        return sorted(self.rank_ops)


def scan_partition(source: Union[str, TraceReader]) -> PartitionScan:
    """Scan a trace once (raw chunks, columns never expanded) and return
    the partitionable structure :func:`repro.corpus.parallel_replay`
    plans shards from."""
    reader = (source if isinstance(source, TraceReader)
              else iter_trace(str(source), expand=False))
    rank_ops: Dict[int, int] = {}
    n_phases = 1
    n_ops = 0
    for rec in reader:
        kind = rec["t"]
        if kind == REC_CHUNK:
            n = rec["n"]
            n_ops += n
            r = rec["r"]
            if type(r) is int:
                rank_ops[r] = rank_ops.get(r, 0) + n
            else:
                vals, counts = np.unique(
                    np.cumsum(np.asarray(r, dtype=np.int64)),
                    return_counts=True)
                for rank, cnt in zip(vals.tolist(), counts.tolist()):
                    rank_ops[rank] = rank_ops.get(rank, 0) + cnt
        elif kind == REC_POST or kind == REC_ARRIVE:
            n_ops += 1
            rank = rec["rank"]
            rank_ops[rank] = rank_ops.get(rank, 0) + 1
        elif kind == REC_PHASE:
            n_phases += 1
    return PartitionScan(header=reader.header, rank_ops=rank_ops,
                         n_phases=n_phases, n_ops=n_ops)


class Replayer:
    """Re-drive a recorded trace through an alternate engine config.

    ``mode`` overrides the engine mode (default: the recorded one);
    ``progress_mode`` picks the queue discipline for progress-engine lane
    events (default: leave them out unless the trace has any, then replay
    as ``"incoming"``). ``check_matches=False`` selects the batched
    streaming path (no per-op outcome verification — see the module
    docstring).

    The batched path can additionally replay a *partition* of the stream
    (the primitive under :mod:`repro.corpus` sharded replay):

      * ``ranks`` — replay only these ranks' ops. Sound because every
        rank's engine is fully independent: filtering is exact, not
        approximate, and the per-phase stats for the selected ranks are
        identical to a full replay's.
      * ``phase_range=(lo, hi)`` — record only phases ``lo..hi-1``.
        Engine state (UMQ leaks, posted receives) legitimately crosses
        phase boundaries, so earlier phases are still *driven* as warmup
        with counters disabled; the stream is abandoned once ``hi`` is
        reached unless the range extends to the end (the tail shard also
        owns the trailing progress records and snapshot).

    Both require ``check_matches=False`` (the verification path compares
    per-op outcomes against the full recorded stream and would report
    every filtered op as a divergence)."""

    def __init__(self, mode: Optional[str] = None,
                 progress_mode: Optional[str] = None,
                 phase_ns: int = PHASE_NS, check_matches: bool = True,
                 ranks: Optional[Iterable[int]] = None,
                 phase_range: Optional[Tuple[int, int]] = None,
                 strict: bool = True):
        self.mode = mode
        self.progress_mode = progress_mode
        self.phase_ns = phase_ns
        self.check_matches = check_matches
        # strict=False opens path sources leniently: corrupt lines are
        # skipped by the reader and tallied into the result's
        # ``skipped_records`` instead of aborting the replay
        self.strict = strict
        self.ranks: Optional[FrozenSet[int]] = (
            None if ranks is None else frozenset(ranks))
        self.phase_range = phase_range
        if check_matches and (self.ranks is not None
                              or phase_range is not None):
            raise ValueError(
                "partitioned replay (ranks/phase_range) requires "
                "check_matches=False")

    def _open(self, source
              ) -> Tuple[Dict, Iterable[Dict]]:
        """(header, record stream). Paths stream through a
        :class:`~repro_torch.trace.io.TraceReader` (raw for the batched path,
        expanded for verification); ``(header, records)`` tuples and
        open readers are consumed as given."""
        if isinstance(source, TraceReader):
            records: Iterable[Dict] = source
            if self.check_matches and not source.expand:
                # the verifying loop speaks per-op records only — a raw
                # reader's chunks must be expanded inline
                records = _expand_stream(records)
            return source.header, records
        if isinstance(source, (tuple, list)):
            header, records = source
            if self.check_matches:
                records = _expand_stream(records)
            return header, records
        reader = iter_trace(str(source), expand=self.check_matches,
                            strict=self.strict)
        return reader.header, reader

    def run(self, source: Union[str, TraceReader,
                                Tuple[Dict, Sequence[Dict]]]
            ) -> ReplayResult:
        header, records = self._open(source)
        if self.check_matches:
            result = self._run_checked(header, records)
        else:
            result = self._run_batched(header, records)
        reader = (records if isinstance(records, TraceReader)
                  else source if isinstance(source, TraceReader)
                  else None)
        if reader is not None and reader.skipped:
            result.skipped_records = dict(reader.skipped)
        return result

    # -- per-op verification path -----------------------------------------

    def _run_checked(self, header: Dict,
                     records: Iterable[Dict]) -> ReplayResult:
        mode = canonical_mode(self.mode or header.get("mode", "binned"))

        registry = CounterRegistry()
        engines: Dict[int, MatchEngine] = {}

        def engine(rank: int) -> MatchEngine:
            eng = engines.get(rank)
            if eng is None:
                eng = engines[rank] = MatchEngine(
                    rank=rank, mode=mode, registry=registry.lane(rank))
            return eng

        phases: List[PhaseStats] = []
        events: List[Event] = []
        matches: List[Tuple[int, str, int, Optional[int]]] = []
        divergences: List[Dict] = []
        pe_records: List[Dict] = []
        recorded_stats: Optional[Dict[int, Dict[str, CounterStat]]] = None
        current = PhaseStats(index=0, label="prologue", op="phase")
        wall: List[int] = []          # t_wall stamps seen in current phase

        def flush_phase() -> None:
            t = (len(phases) + 1) * self.phase_ns
            evs = registry.snapshot_events(t_ns=t)
            per: Dict[int, List[Event]] = {}
            for ev in evs:
                ev.attrs["phase"] = current.label
                ev.attrs["phase_index"] = current.index
                per.setdefault(ev.pid, []).append(ev)
            current.stats = {pidx: counter_stats(group)
                             for pidx, group in per.items()}
            if wall:
                current.wall_ns = max(wall) - min(wall)
                del wall[:]
            phases.append(current)
            events.extend(evs)

        for rec in records:
            kind = rec["t"]
            if "t_wall" in rec:
                wall.append(rec["t_wall"])
            if kind == REC_PHASE:
                flush_phase()
                current = PhaseStats(
                    index=len(phases), label=rec["label"], op=rec["op"],
                    attrs={k: v for k, v in rec.items()
                           if k not in ("t", "op", "label")})
            elif kind == REC_POST:
                r = engine(rec["rank"]).post_recv(
                    src=rec["src"], tag=rec["tag"], comm=rec.get("comm", 0))
                got = r.message.seq if r.message is not None else None
                matches.append((rec["rank"], "post", r.seq, got))
                if "hit" in rec and rec["hit"] != got:
                    divergences.append(
                        {"rec": rec, "replayed": got, "mode": mode})
            elif kind == REC_ARRIVE:
                r = engine(rec["rank"]).arrive(
                    src=rec["src"], tag=rec["tag"],
                    comm=rec.get("comm", 0), nbytes=rec.get("nb", 0))
                got = r.seq if r is not None else None
                matches.append((rec["rank"], "arr", rec["seq"], got))
                if "match" in rec and rec["match"] != got:
                    divergences.append(
                        {"rec": rec, "replayed": got, "mode": mode})
            elif kind == REC_PROGRESS:
                pe_records.append(rec)
            elif kind == REC_SNAPSHOT:
                recorded_stats = _parse_snap(rec)
        flush_phase()

        progress_mode = self.progress_mode
        progress_events: List[Event] = []
        if pe_records:
            progress_mode = progress_mode or "incoming"
            progress_events = replay_progress(pe_records, progress_mode)
            events.extend(progress_events)

        return ReplayResult(
            mode=mode, progress_mode=progress_mode, header=header,
            matches=matches, divergences=divergences, phases=phases,
            events=events, progress_events=progress_events,
            pe_records=pe_records, registry=registry,
            recorded_stats=recorded_stats, n_ops=len(matches))

    # -- batched streaming path -------------------------------------------

    def _run_batched(self, header: Dict,
                     records: Iterable[Dict]) -> ReplayResult:
        """Decode straight into the batch engine APIs: chunk columns
        become flat ``run_ops`` quint streams per rank, dispatched once
        per (rank, phase). Recorded ``seq``/outcome columns are not even
        decoded — matching outcomes are deterministic, and the
        verification path exists when they must be re-checked."""
        mode = canonical_mode(self.mode or header.get("mode", "binned"))

        # lanes-only: every consumer of this registry reads per-rank
        # lane deltas (the per-phase snapshots); the cross-lane
        # aggregate would double the drain work unread
        registry = CounterRegistry(lanes_only=True)
        engines: Dict[int, MatchEngine] = {}

        def engine(rank: int) -> MatchEngine:
            eng = engines.get(rank)
            if eng is None:
                eng = engines[rank] = MatchEngine(
                    rank=rank, mode=mode, registry=registry.lane(rank))
            return eng

        rsel = self.ranks
        prange = self.phase_range
        lo, hi = prange if prange is not None else (0, None)
        # rec_on: current phase is inside the recorded range. Warmup
        # phases (phase partitioning) are driven with counters disabled —
        # the engine checks ``registry.enabled`` per counting site, so
        # queue state evolves identically while stats stay silent.
        rec_on = prange is None or lo <= 0
        if prange is not None:
            registry.enabled = rec_on
        stopped = False

        phases: List[PhaseStats] = []
        pe_records: List[Dict] = []
        raw_snap: Optional[Dict] = None
        pidx = 0
        current = PhaseStats(index=0, label="prologue", op="phase")
        # rank -> ordered dispatch segments, each one batch-engine call:
        #   [1, tag, comm, 0,  srcs]   post_recv_batch / post_recv
        #   [0, tag, comm, nb, srcs]   arrive_batch / arrive
        #   [3, src, comm, 0,  tags]   post_recv_tags
        #   [4, src, comm, nb, tags]   arrive_tags
        #   [2, 0,   0,    0,  quints] run_ops (mixed/varying envelope)
        pending: Dict[int, List[List]] = {}
        get_segs = pending.get
        wall_lo: Optional[int] = None    # t_wall span of current phase
        wall_hi = 0
        n_ops = 0

        def flush_ops() -> None:
            for rank in sorted(pending):
                eng = engine(rank)
                segs_r = pending[rank]
                quints: Optional[List] = None
                for kind_, a, comm_, nb_, items in segs_r:
                    if kind_ <= 1 and len(items) == 1:
                        # singleton segment (envelope changed every op —
                        # alternating-tag phases): fold runs of these
                        # into one run_ops quint stream instead of a
                        # per-op API call per segment
                        if quints is None:
                            quints = []
                        quints += (kind_, items[0], a, nb_, comm_)
                        continue
                    if quints is not None:
                        eng.run_ops(quints)
                        quints = None
                    if kind_ == 1:
                        eng.post_recv_batch(items, a, comm_)
                    elif kind_ == 0:
                        eng.arrive_batch(items, a, comm_, nb_)
                    elif kind_ == 2:
                        eng.run_ops(items)
                    elif kind_ == 3:
                        eng.post_recv_tags(a, items, comm_)
                    else:
                        eng.arrive_tags(a, items, comm_, nb_)
                if quints is not None:
                    eng.run_ops(quints)
            pending.clear()

        def flush_phase() -> None:
            # streaming flush: per-rank stats come straight off the
            # columnar counter-sink drain (snapshot_lanes) — no Event
            # materialization, no attrs round-trip; ReplayResult builds
            # the identical Events lazily if anything asks for them.
            # Warmup phases (outside phase_range) still dispatch and
            # reset the wall span, but record nothing.
            nonlocal wall_lo
            flush_ops()
            if rec_on:
                current.stats = registry.snapshot_lanes()
                if wall_lo is not None:
                    current.wall_ns = wall_hi - wall_lo
                phases.append(current)
            wall_lo = None

        for rec in records:
            kind = rec["t"]
            if kind == REC_CHUNK:
                n = rec["n"]
                w = rec.get("w")
                if w is not None:
                    # t_wall is monotone within a chunk: the span is
                    # first value .. cumulative sum of the delta list
                    if type(w) is int:
                        wlo = whi = w
                    else:
                        wlo, whi = w[0], sum(w)
                    if wall_lo is None:
                        wall_lo = wlo
                    wall_hi = whi
                p = rec["p"]
                r = rec["r"]
                if rsel is not None and type(r) is int and r not in rsel:
                    continue
                # op accounting: whole constant-rank chunks (and every
                # chunk when unfiltered) count here; rank-varying chunks
                # under a rank filter count per group below
                split_count = rsel is not None and type(r) is not int
                if rec_on and not split_count:
                    n_ops += n
                s = rec["s"]
                g = rec["g"]
                c = rec.get("c", 0)
                b = rec.get("b", 0)
                env_const = (type(g) is int and type(c) is int
                             and type(b) is int)
                if type(p) is int and type(r) is int and env_const:
                    # uniform-kind single-rank constant-envelope chunk
                    # -> one post_recv_batch/arrive_batch segment
                    segs = get_segs(r)
                    if segs is None:
                        segs = pending[r] = []
                    segs.append([p, g, c, 0 if p else b,
                                 [s] * n if type(s) is int
                                 else list(accumulate(s))])
                    continue
                if (type(p) is int and type(r) is int
                        and type(s) is int and type(c) is int
                        and type(b) is int):
                    # tag-scan chunk (fixed src, varying tags) -> one
                    # post_recv_tags/arrive_tags segment
                    segs = get_segs(r)
                    if segs is None:
                        segs = pending[r] = []
                    segs.append([3 if p else 4, s, c, 0 if p else b,
                                 list(accumulate(g))])
                    continue
                if n >= 64:
                    # large multi-rank chunk: expand columns and group
                    # rows by rank (cumsum over the delta lists, one
                    # stable argsort) at C speed
                    fa = (np.full(n, p, dtype=np.int64)
                          if type(p) is int
                          else np.asarray(decode_flags(p, n),
                                          dtype=np.int64))
                    ra = (np.full(n, r, dtype=np.int64)
                          if type(r) is int
                          else np.cumsum(np.asarray(r, dtype=np.int64)))
                    sa = (np.full(n, s, dtype=np.int64)
                          if type(s) is int
                          else np.cumsum(np.asarray(s, dtype=np.int64)))
                    order = np.argsort(ra, kind="stable")
                    sr = ra[order]
                    cuts = np.flatnonzero(sr[1:] != sr[:-1]) + 1
                    if env_const:
                        # per rank, split into kind runs -> batch
                        # segments with the src block lifted wholesale
                        for idx in np.split(order, cuts):
                            rank = int(ra[idx[0]])
                            if rsel is not None and rank not in rsel:
                                continue
                            if rec_on and split_count:
                                n_ops += len(idx)
                            segs = get_segs(rank)
                            if segs is None:
                                segs = pending[rank] = []
                            subf = fa[idx]
                            kcuts = np.flatnonzero(
                                subf[1:] != subf[:-1]) + 1
                            for ridx in (np.split(idx, kcuts)
                                         if len(kcuts) else (idx,)):
                                k_ = int(fa[ridx[0]])
                                segs.append(
                                    [k_, g, c, 0 if k_ else b,
                                     sa[ridx].tolist()])
                        continue
                    # varying envelope: quint matrix -> run_ops segment
                    m = np.empty((n, 5), dtype=np.int64)
                    m[:, 0] = fa
                    m[:, 1] = sa
                    m[:, 2] = (g if type(g) is int
                               else np.cumsum(np.asarray(
                                   g, dtype=np.int64)))
                    if type(b) is int:
                        m[:, 3] = np.where(fa == 1, 0, b)
                    else:
                        m[:, 3] = 0
                        m[fa == 0, 3] = np.cumsum(np.asarray(
                            b, dtype=np.int64))
                    m[:, 4] = (c if type(c) is int
                               else np.cumsum(np.asarray(
                                   c, dtype=np.int64)))
                    for idx in np.split(order, cuts):
                        rank = int(ra[idx[0]])
                        if rsel is not None and rank not in rsel:
                            continue
                        if rec_on and split_count:
                            n_ops += len(idx)
                        segs = get_segs(rank)
                        if segs is None:
                            segs = pending[rank] = []
                        segs.append([2, 0, 0, 0,
                                     m[idx].ravel().tolist()])
                    continue
                flags = (repeat(p, n) if type(p) is int
                         else decode_flags(p, n))
                ranks = repeat(r, n) if type(r) is int else accumulate(r)
                srcs = repeat(s, n) if type(s) is int else accumulate(s)
                tags = repeat(g, n) if type(g) is int else accumulate(g)
                comms = repeat(c, n) if type(c) is int else accumulate(c)
                nbs = (repeat(b) if type(b) is int
                       else iter(list(accumulate(b))))
                for p_, r_, s_, g_, c_ in zip(flags, ranks, srcs, tags,
                                              comms):
                    nb_ = 0 if p_ else next(nbs)
                    if rsel is not None and r_ not in rsel:
                        continue
                    if rec_on and split_count:
                        n_ops += 1
                    segs = get_segs(r_)
                    if segs is None:
                        segs = pending[r_] = [[p_, g_, c_, nb_, [s_]]]
                        continue
                    last = segs[-1]
                    if (last[0] == p_ and last[1] == g_
                            and last[2] == c_ and last[3] == nb_):
                        last[4].append(s_)
                    else:
                        segs.append([p_, g_, c_, nb_, [s_]])
                continue
            tw = rec.get("t_wall")
            if tw is not None:
                if wall_lo is None:
                    wall_lo = tw
                wall_hi = tw
            if kind == REC_POST or kind == REC_ARRIVE:
                r = rec["rank"]
                if rsel is not None and r not in rsel:
                    continue
                if rec_on:
                    n_ops += 1
                p_ = 1 if kind == REC_POST else 0
                g_ = rec["tag"]
                c_ = rec.get("comm", 0)
                nb_ = 0 if p_ else rec.get("nb", 0)
                s_ = rec["src"]
                segs = get_segs(r)
                if segs is None:
                    pending[r] = [[p_, g_, c_, nb_, [s_]]]
                else:
                    last = segs[-1]
                    if (last[0] == p_ and last[1] == g_
                            and last[2] == c_ and last[3] == nb_):
                        last[4].append(s_)
                    else:
                        segs.append([p_, g_, c_, nb_, [s_]])
            elif kind == REC_PHASE:
                flush_phase()
                pidx += 1
                current = PhaseStats(
                    index=pidx, label=rec["label"], op=rec["op"],
                    attrs={k: v for k, v in rec.items()
                           if k not in ("t", "op", "label")})
                if prange is not None:
                    rec_on = lo <= pidx < hi
                    registry.enabled = rec_on
                    if pidx >= hi:
                        # range fully recorded and it does not extend to
                        # the stream tail: nothing left for this shard
                        stopped = True
                        break
            elif kind == REC_PROGRESS:
                # under phase partitioning, aux records (progress lanes,
                # final snapshot) belong to the shard whose range covers
                # them; the merge concatenates shards in phase order
                if rec_on:
                    pe_records.append(rec)
            elif kind == REC_PE_CHUNK:
                if not rec_on:
                    continue
                expanded = decode_pe_chunk(rec)
                pe_records.extend(expanded)
                for pe in expanded:
                    tw = pe.get("t_wall")
                    if tw is not None:
                        if wall_lo is None:
                            wall_lo = tw
                        wall_hi = tw
            elif kind == REC_SNAPSHOT:
                if rec_on:
                    raw_snap = rec
        if not stopped:
            flush_phase()

        progress_mode = self.progress_mode
        if pe_records:
            progress_mode = progress_mode or "incoming"

        return ReplayResult(
            mode=mode, progress_mode=progress_mode, header=header,
            matches=[], divergences=[], phases=phases,
            registry=registry, pe_records=pe_records,
            raw_snap=raw_snap, n_ops=n_ops, phase_ns=self.phase_ns)


def replay(source: Union[str, TraceReader, Tuple[Dict, Sequence[Dict]]],
           mode: Optional[str] = None,
           progress_mode: Optional[str] = None,
           check_matches: bool = True,
           strict: bool = True) -> ReplayResult:
    """One-call replay: ``replay(path, mode="linear")``;
    ``check_matches=False`` streams batched (fast, no per-op outcome
    verification); ``strict=False`` skips corrupt source lines (see
    ``ReplayResult.skipped_records``)."""
    return Replayer(mode=mode, progress_mode=progress_mode,
                    check_matches=check_matches, strict=strict
                    ).run(source)
