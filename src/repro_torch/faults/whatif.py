"""Fault-aware what-if replay: predict a faulted run from a healthy trace.

:func:`whatif` applies a :class:`~repro_torch.faults.plan.FaultPlan` (and
optionally a :class:`~repro_torch.faults.recovery.RecoveryPolicy`) to the
decoded op stream of a *healthy* recorded trace and replays the
transformed stream through the batched replayer
(:class:`repro_torch.trace.replay.Replayer`, ``check_matches=False``) — no
scenario re-drive, no fabric, no live engines beyond the replay ones.
The result predicts the faulted run's per-phase counter lanes and
detector findings.

**How the stream is reconstructed.** A traced fabric exchange of ``n``
pairs is laid out as ``[early posts][all n arrivals][late posts]``
(:meth:`repro_torch.match.engine.Fabric._exchange`), where a post at global
tick ``t`` is late iff ``t % unexpected_every == 0`` and ticks advance
one per pair. Walking the stream with that tick arithmetic segments it
back into exchanges *exactly*: per exchange, the contiguous arrival
run has length ``n``, the late-post count is ``L = #{t in (k, k+n] :
t % ue == 0}``, and the preceding early-post run must have length
``n - L`` (checked — a stream that is not fabric-shaped raises
:class:`WhatIfError`). ``unexpected_every`` is resolved from the
trace header's scenario name via the workloads registry, or passed
explicitly.

**How faults are applied.** Each reconstructed exchange goes through
the same two rewrite stages as :class:`~repro_torch.faults.inject
.FaultyFabric`, in the same spec order, drawing from the same
``random.Random(plan.seed)`` fault stream (and, with a policy, the
same dedicated :func:`~repro_torch.faults.recovery.recovery_stream`): for
``drop``/``duplicate``/``reorder``/``delay`` the plan leaves the pairs
untouched, so the healthy trace's arrival order *is* the injector's
candidate order and the prediction consumes the identical rng draw
sequence — counter-exact up to tick effects. ``rank_leave`` /
``rank_join`` change the pair lists themselves, which shifts the
downstream unexpected/wildcard tick mix in a live run; the what-if
edits the recorded posts/arrivals without re-deriving wildcards (a
recorded wildcard post has already lost its concrete source), so those
two kinds are verdict-exact but approximate in the stat columns — the
tolerance ``benchmarks/whatif_bench.py`` measures and declares.

Injector-side evidence counters (``fault.delay.deferred`` and the
``fault.recovery.*`` family) never reach the replayed engines, so the
transform accumulates them in a synthetic evidence registry; the
:class:`WhatIfResult` merges those lanes into its event stream before
running the detectors — with no policy and no delay spec the evidence
is empty and the what-if's finding surface is computed exactly like
the corpus gate's (``repro_torch.corpus.codec.finding_kinds``).

The recorded final ``snap`` record is dropped (the prediction
invalidates it); phase markers and progress-lane records pass through
unchanged, and deferred/retransmitted deliveries still in flight when
the op stream ends are flushed ahead of the trailing progress records,
exactly where :meth:`FaultyFabric.finish` lands them in a live run.

A copy of ``repro.faults.whatif``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import random
from typing import (Dict, Iterable, Iterator, List, Optional, Tuple,
                    Union)

from ..core import analyses
from ..core.counters import CounterRegistry, lane_events
from ..core.events import Event
from ..trace.io import TraceReader, iter_trace
from ..trace.replay import Replayer, ReplayResult
from ..trace.schema import (REC_ARRIVE, REC_PE_CHUNK, REC_PHASE,
                            REC_POST, REC_PROGRESS, REC_SNAPSHOT)
from .plan import FaultPlan
from .recovery import (EV_CANCELLED, EV_RETRANSMIT, EV_RETRY,
                       EV_SUPPRESSED, RecoveryPolicy, RecoveryRule,
                       recovery_stream)

# fallback when the trace names no registered scenario and the caller
# passed no override (the Fabric constructor's own default)
DEFAULT_UNEXPECTED_EVERY = 3


class WhatIfError(ValueError):
    """The record stream is not fabric-exchange shaped (or was
    segmented with the wrong ``unexpected_every``)."""


def resolve_unexpected_every(header: Dict,
                             unexpected_every: Optional[int] = None
                             ) -> int:
    """The tick period that segments this trace's op stream back into
    exchanges: an explicit override wins; otherwise the scenario named
    in the header's meta is looked up in the workloads registry."""
    if unexpected_every is not None:
        return int(unexpected_every)
    meta = header.get("meta") or {}
    name = meta.get("scenario")
    if name:
        # lazy: workloads imports repro_torch.faults for its fault axis
        from ..workloads.base import get as get_scenario
        try:
            return int(get_scenario(name).unexpected_every)
        except KeyError:
            pass
    return DEFAULT_UNEXPECTED_EVERY


class _Transform:
    """Streaming exchange segmenter + plan applicator (one pass)."""

    def __init__(self, plan: FaultPlan,
                 policy: Optional[RecoveryPolicy],
                 unexpected_every: int,
                 evidence: CounterRegistry):
        self.plan = plan
        self.unexpected_every = unexpected_every
        self.evidence = evidence
        self._rules: Dict[str, RecoveryRule] = (
            {r.kind: r for r in policy.rules}
            if policy is not None and policy.rules else {})
        self._frng = random.Random(plan.seed)
        self._rrng = (recovery_stream(plan.seed)
                      if self._rules else None)
        self._k = 0               # global tick of the *healthy* stream
        self._x = 0               # exchange index (the plan's windows)
        # in-flight delayed arrivals: (due_x, arr record)
        self._deferred: List[Tuple[int, Dict]] = []
        # scheduled retransmits: (due_x, attempt, loss_rate, arr record)
        self._retrans: List[Tuple[int, int, float, Dict]] = []
        self.stats: Dict[str, int] = {
            "exchanges": 0, "dropped": 0, "duplicated": 0,
            "suppressed": 0, "deferred": 0, "reordered": 0,
            "cancelled": 0, "retransmitted": 0, "retried": 0,
            "joined": 0, "left": 0, "snapshots_dropped": 0}

    def _lane(self, pid: int):
        return self.evidence.lane(pid)

    # -- stream walk -------------------------------------------------------

    def run(self, records: Iterable[Dict]) -> Iterator[Dict]:
        it = iter(records)
        pushed: Optional[Dict] = None
        flushed = False

        def nxt() -> Optional[Dict]:
            nonlocal pushed
            if pushed is not None:
                rec, pushed = pushed, None
                return rec
            return next(it, None)

        while True:
            rec = nxt()
            if rec is None:
                break
            kind = rec.get("t")
            if kind == REC_POST or kind == REC_ARRIVE:
                pushed = rec
                out, pushed = self._parse_exchange(nxt)
                yield from out
            elif kind in (REC_PROGRESS, REC_PE_CHUNK, REC_SNAPSHOT):
                if not flushed:
                    # the op stream is over: land the still-in-flight
                    # deliveries where FaultyFabric.finish would
                    yield from self._finish()
                    flushed = True
                if kind == REC_SNAPSHOT:
                    # the recorded final counter snapshot describes the
                    # healthy run; the prediction invalidates it
                    self.stats["snapshots_dropped"] += 1
                    continue
                yield rec
            else:
                yield rec             # phase markers, annotations
        if not flushed:
            yield from self._finish()

    def _parse_exchange(self, nxt) -> Tuple[List[Dict], Optional[Dict]]:
        """Segment one exchange off the stream (early posts, arrival
        run, tick-derived late posts), apply the plan, and return the
        transformed records plus the first record past the exchange."""
        early: List[Dict] = []
        rec = nxt()
        while rec is not None and rec.get("t") == REC_POST:
            early.append(rec)
            rec = nxt()
        arrs: List[Dict] = []
        while rec is not None and rec.get("t") == REC_ARRIVE:
            arrs.append(rec)
            rec = nxt()
        n = len(arrs)
        x = self._x
        if n == 0:
            raise WhatIfError(
                f"exchange {x}: {len(early)} post(s) with no arrival "
                "run — not a fabric exchange stream")
        ue = self.unexpected_every
        k = self._k
        n_late = (k + n) // ue - k // ue if ue else 0
        if len(early) + n_late != n:
            raise WhatIfError(
                f"exchange {x}: {len(early)} early posts + {n_late} "
                f"tick-derived late posts != {n} arrivals (is "
                f"unexpected_every={ue} right for this trace?)")
        late: List[Dict] = []
        for _ in range(n_late):
            if rec is None or rec.get("t") != REC_POST:
                raise WhatIfError(
                    f"exchange {x}: expected {n_late} late post(s) "
                    "after the arrival run, stream ended or changed "
                    "kind early")
            late.append(rec)
            rec = nxt()
        self._k = k + n
        self._x = x + 1
        self.stats["exchanges"] += 1
        return self._apply(x, early, late, arrs), rec

    # -- plan application (mirrors FaultyFabric op for op) -----------------

    def _apply(self, x: int, early: List[Dict], late: List[Dict],
               arrs: List[Dict]) -> List[Dict]:
        out: List[Dict] = []
        if self._deferred:
            due = [e for e in self._deferred if e[0] <= x]
            if due:
                self._deferred = [e for e in self._deferred
                                  if e[0] > x]
                out.extend(r for _, r in due)
        if self._retrans:
            out.extend(self._release_retrans(x))
        active = self.plan.active(x)
        if active:
            # participation rewrites first (the injector edits pairs/
            # deliver before the base exchange dispatches them)
            for spec in active:
                kind = spec.kind
                if kind == "rank_leave":
                    dead = spec.rank
                    kept_e = [p for p in early if p["rank"] != dead]
                    kept_l = [p for p in late if p["rank"] != dead]
                    if len(kept_e) + len(kept_l) != \
                            len(early) + len(late):
                        self.stats["left"] += (
                            len(early) + len(late)
                            - len(kept_e) - len(kept_l))
                        early, late = kept_e, kept_l
                        arrs = [a for a in arrs if a["rank"] != dead]
                    if "rank_leave" in self._rules:
                        # peers cancel the receives they would have
                        # orphaned (recorded wildcard posts have lost
                        # their concrete source and are kept — the
                        # declared rank_leave approximation)
                        nc = 0
                        for p in early + late:
                            if p["src"] == dead:
                                nc += 1
                                self._lane(p["rank"]).count(
                                    EV_CANCELLED, 1)
                        if nc:
                            self.stats["cancelled"] += nc
                            early = [p for p in early
                                     if p["src"] != dead]
                            late = [p for p in late
                                    if p["src"] != dead]
                            arrs = [a for a in arrs
                                    if a["src"] != dead]
                elif kind == "rank_join" \
                        and (x - spec.start) % spec.every == 0:
                    src0 = arrs[0] if arrs else None
                    tag = src0["tag"] if src0 else 0
                    comm = src0.get("comm", 0) if src0 else 0
                    nb = src0.get("nb", 0) if src0 else 0
                    joiner = spec.rank
                    for dst, src in ((joiner, 0), (0, joiner)):
                        early.append({"t": REC_POST, "rank": dst,
                                      "src": src, "tag": tag,
                                      "comm": comm})
                        arrs.append({"t": REC_ARRIVE, "rank": dst,
                                     "src": src, "tag": tag,
                                     "comm": comm, "nb": nb})
                    self.stats["joined"] += 2
            # then the arrival-stream rewrites, same spec order and
            # candidate iteration as FaultyFabric._filter_arrivals —
            # one fault-stream draw per candidate, in stream order
            rng = self._frng
            for spec in active:
                kind = spec.kind
                if kind == "drop":
                    kept = []
                    want = spec.rank
                    rate = spec.rate
                    rule = self._rules.get("drop")
                    for a in arrs:
                        if (want < 0 or a["src"] == want) \
                                and rng.random() < rate:
                            self.stats["dropped"] += 1
                            if rule is not None:
                                self._schedule_retransmit(
                                    rule, x, 0, rate, a)
                        else:
                            kept.append(a)
                    arrs = kept
                elif kind == "duplicate":
                    dup = []
                    want = spec.rank
                    rate = spec.rate
                    suppress = "duplicate" in self._rules
                    for a in arrs:
                        dup.append(a)
                        if (want < 0 or a["src"] == want) \
                                and rng.random() < rate:
                            if suppress:
                                self.stats["suppressed"] += 1
                                self._lane(a["rank"]).count(
                                    EV_SUPPRESSED, 1)
                            else:
                                dup.append(dict(a))
                                self.stats["duplicated"] += 1
                    arrs = dup
                elif kind == "delay":
                    kept = []
                    nd = 0
                    want = spec.rank
                    due = x + spec.hold
                    for a in arrs:
                        if a["src"] == want:
                            self._deferred.append((due, a))
                            nd += 1
                        else:
                            kept.append(a)
                    if nd:
                        arrs = kept
                        self.stats["deferred"] += nd
                        # the injector-side straggler evidence the
                        # live straggler_rank signal keys on
                        self._lane(want).count(
                            "fault.delay.deferred", nd)
                elif kind == "reorder":
                    m = len(arrs)
                    if m > 1:
                        keyed = sorted(
                            (i + rng.randrange(spec.k + 1), i)
                            for i in range(m))
                        arrs = [arrs[i] for _, i in keyed]
                        self.stats["reordered"] += m
                elif kind == "rank_leave":
                    arrs = [a for a in arrs if a["src"] != spec.rank]
        out.extend(early)
        out.extend(arrs)
        out.extend(late)
        return out

    # -- recovery plumbing (mirrors the injector's) ------------------------

    def _schedule_retransmit(self, rule: RecoveryRule, x: int,
                             attempt: int, rate: float,
                             arec: Dict) -> None:
        due = x + rule.delay(attempt, self._rrng)
        self._retrans.append((due, attempt + 1, rate, arec))

    def _release_retrans(self, x: int) -> List[Dict]:
        due = [e for e in self._retrans if e[0] <= x]
        if not due:
            return []
        self._retrans = [e for e in self._retrans if e[0] > x]
        rrng = self._rrng
        rule = self._rules["drop"]
        out: List[Dict] = []
        for _, attempt, rate, arec in due:
            if attempt <= rule.max_retries and rrng.random() < rate:
                self.stats["retried"] += 1
                self._lane(arec["rank"]).count(EV_RETRY, 1)
                self._schedule_retransmit(rule, x, attempt, rate, arec)
            else:
                self.stats["retransmitted"] += 1
                self._lane(arec["rank"]).count(EV_RETRANSMIT, 1)
                out.append(arec)
        return out

    def _finish(self) -> Iterator[Dict]:
        """End-of-stream flush, exactly where ``FaultyFabric.finish``
        lands: every still-deferred arrival, then every still-pending
        retransmit (the modeled reliable channel always converges)."""
        if self._deferred:
            deferred, self._deferred = self._deferred, []
            for _, arec in deferred:
                yield arec
        if self._retrans:
            retrans, self._retrans = self._retrans, []
            for _, _, _, arec in retrans:
                self.stats["retransmitted"] += 1
                self._lane(arec["rank"]).count(EV_RETRANSMIT, 1)
                yield arec


class WhatIfResult:
    """A what-if prediction: the batched :class:`ReplayResult` of the
    transformed stream, plus the synthetic injector-side evidence lanes
    and the detector surface computed over both."""

    def __init__(self, replay: ReplayResult, plan: FaultPlan,
                 policy: Optional[RecoveryPolicy],
                 evidence_events: List[Event],
                 stats: Dict[str, int],
                 unexpected_every: int):
        self.replay = replay
        self.plan = plan
        self.policy = policy
        self.evidence_events = evidence_events
        self.stats = stats
        self.unexpected_every = unexpected_every
        self._findings = None

    @property
    def phases(self):
        return self.replay.phases

    @property
    def header(self) -> Dict:
        return self.replay.header

    @property
    def mode(self) -> str:
        return self.replay.mode

    @property
    def n_ops(self) -> int:
        return self.replay.n_ops

    @property
    def events(self) -> List[Event]:
        """Replayed counter/progress events plus the evidence lanes —
        what the detectors see in a live faulted run."""
        return self.replay.events + self.evidence_events

    @property
    def findings(self):
        if self._findings is None:
            self._findings = analyses.analyze_all(self.events)
        return self._findings

    @property
    def finding_kinds(self) -> List[str]:
        """Sorted detector kinds — the corpus gate's comparison unit
        (:func:`repro_torch.corpus.codec.finding_kinds`)."""
        return sorted({f.kind for f in self.findings})


def whatif(source: Union[str, TraceReader, Tuple[Dict, List[Dict]]],
           plan: FaultPlan,
           policy: Optional[RecoveryPolicy] = None,
           mode: Optional[str] = None,
           progress_mode: Optional[str] = None,
           unexpected_every: Optional[int] = None) -> WhatIfResult:
    """Predict what ``plan`` (optionally healed by ``policy``) would
    have done to the run recorded in ``source`` — a healthy trace path,
    an expanded :class:`TraceReader`, or an ``(header, records)`` pair
    with chunks already expanded."""
    if isinstance(source, TraceReader):
        if not source.expand:
            raise ValueError(
                "whatif needs an expanded record stream (chunks "
                "decoded): open the reader with expand=True")
        header, records = source.header, iter(source)
    elif isinstance(source, (tuple, list)):
        header, records = source
    else:
        reader = iter_trace(str(source), expand=True)
        header, records = reader.header, reader
    ue = resolve_unexpected_every(header, unexpected_every)
    evidence = CounterRegistry()
    tr = _Transform(plan, policy, ue, evidence)
    replay = Replayer(mode=mode, progress_mode=progress_mode,
                      check_matches=False).run((header, tr.run(records)))
    t_ns = (len(replay.phases) + 1) * replay.phase_ns
    evidence_events = lane_events(evidence.drain_lanes(), t_ns=t_ns)
    return WhatIfResult(replay=replay, plan=plan, policy=policy,
                        evidence_events=evidence_events,
                        stats=tr.stats, unexpected_every=ue)
