"""Deterministic fault injection over the matching fabric.

:class:`FaultyFabric` is a :class:`repro_torch.match.Fabric` that rewrites
every exchange through a :class:`repro_torch.faults.plan.FaultPlan` before
dispatch, using the two sanctioned seams the engine exposes:

  * **participation rewrites** (``rank_leave`` / ``rank_join``) edit
    the ``pairs``/``deliver`` lists in lockstep *before* the base
    ``exchange`` validates them — a dead rank stops posting receives
    and a joiner adds balanced warm-up traffic, so the lists stay
    mutually consistent;
  * **arrival-stream rewrites** (``drop`` / ``duplicate`` / ``delay``
    / ``reorder``) run through ``Fabric.arrival_filter`` — the one
    place an arrival list may legally stop being a permutation of the
    posts — so the engines see *real* orphaned posts, double arrivals
    and displaced deliveries, and every detector exercises the same
    counter algebra it would on a production trace.

All randomness comes from one ``random.Random(plan.seed)`` stream that
advances identically on the traced and untraced dispatch paths, so the
same ``(scenario, seed, plan)`` produces byte-identical traces and
counter stats. When traced, each (exchange, spec) that fires writes
one ``flt`` record — annotation only: the faulted op stream itself is
carried by the ordinary post/arr records, which is why a faulted trace
replays bit-exactly through :mod:`repro_torch.trace.replay` and shards
cleanly through :mod:`repro_torch.corpus` with no replayer changes.

Delayed (straggler) deliveries are buffered ``hold`` exchanges and
re-injected at the head of a later exchange; :meth:`FaultyFabric
.finish` flushes whatever is still in flight so a run always ends with
every sent message delivered (the straggler signature is the *lag*,
visible as ``fault.delay.deferred`` counts on the straggler's lane and
depth inflation on its peers — not message loss).

With a :class:`repro_torch.faults.recovery.RecoveryPolicy` attached, the
same seams also carry the *healing*: dropped deliveries are
retransmitted after a modeled timeout (with backoff, jitter, and
bounded re-loss from a dedicated recovery rng — the fault stream is
untouched, so the same faults fire healed or not), injected
duplicates are discarded by the receiver's sequence-number window
before the engine sees them, and peers of a dead rank cancel the
receives they would have orphaned. Each recovery action writes one
bare ``rcv`` annotation record (the healed op stream itself is
ordinary post/arr records, so recovering traces replay and convert
exactly like faulted ones).

A copy of ``repro.faults.inject``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import random
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..match.engine import Fabric
from .plan import FaultPlan, FaultSpec
from .recovery import (EV_CANCELLED, EV_RETRANSMIT, EV_RETRY,
                       EV_SUPPRESSED, RecoveryPolicy, RecoveryRule,
                       recovery_stream)


class FaultyFabric(Fabric):
    """A fabric with a fault plan applied to every exchange.

    Drop-in for :class:`Fabric`: scenario harnesses and collectives call
    the same API; each ``exchange`` (including every ring step inside
    a collective) advances the exchange index the plan's windows are
    expressed in."""

    def __init__(self, plan: FaultPlan,
                 recovery: Optional[RecoveryPolicy] = None, **kw):
        super().__init__(**kw)
        self.plan = plan
        self.recovery = (recovery if recovery is not None
                         and recovery.rules else None)
        self._rules: Dict[str, RecoveryRule] = (
            {r.kind: r for r in self.recovery.rules}
            if self.recovery is not None else {})
        # dedicated recovery stream: jitter and lost-retransmit draws
        # never touch the fault stream, so enabling recovery does not
        # change which faults fire
        self._rrng = (recovery_stream(plan.seed)
                      if self.recovery is not None else None)
        self._frng = random.Random(plan.seed)
        self._x = 0                   # exchanges dispatched so far
        self._active: List[FaultSpec] = []
        # in-flight delayed arrivals: (due_x, src, dst, tag, nb, comm)
        self._deferred: Deque[Tuple[int, int, int, int, int, int]] = \
            deque()
        # scheduled retransmits of dropped deliveries:
        # (due_x, attempt, loss_rate, src, dst, tag, nb, comm)
        self._retrans: Deque[
            Tuple[int, int, float, int, int, int, int, int]] = deque()
        self.arrival_filter = self._filter_arrivals

    # -- plan application --------------------------------------------------

    def exchange(self, pairs, tag: int = 0, nbytes: int = 0,
                 comm: int = 0, deliver=None) -> None:
        x = self._x
        self._x = x + 1
        if self._deferred:
            self._release_due(x)
        if self._retrans:
            self._release_retrans(x)
        active = self.plan.active(x)
        if active:
            for spec in active:
                kind = spec.kind
                if kind == "rank_leave":
                    # the dead rank posts nothing: its receives vanish
                    # from the post side here; its outbound traffic is
                    # dropped by the arrival filter below
                    if not isinstance(pairs, (list, tuple)):
                        pairs = list(pairs)
                    kept = [p for p in pairs if p[1] != spec.rank]
                    if len(kept) != len(pairs):
                        if deliver is not None:
                            deliver = [p for p in deliver
                                       if p[1] != spec.rank]
                        self._note(spec, x, len(pairs) - len(kept))
                        pairs = kept
                    if "rank_leave" in self._rules:
                        # peers know the rank is dead: cancel the
                        # receives they would have posted for its
                        # traffic instead of orphaning them
                        dead = spec.rank
                        kept = [p for p in pairs if p[0] != dead]
                        n = len(pairs) - len(kept)
                        if n:
                            if deliver is not None:
                                deliver = [p for p in deliver
                                           if p[0] != dead]
                            for p in pairs:
                                if p[0] == dead:
                                    self._lane(p[1]).count(
                                        EV_CANCELLED, 1)
                            self._note_rcv("cancel", x, n, dead)
                            pairs = kept
                elif kind == "rank_join" \
                        and (x - spec.start) % spec.every == 0:
                    # balanced warm-up round trip with rank 0: the
                    # joiner's lane exists but stays cold vs its peers
                    extra = [(0, spec.rank), (spec.rank, 0)]
                    pairs = list(pairs) + extra
                    if deliver is not None:
                        deliver = list(deliver) + extra
                    self._note(spec, x, len(extra))
        self._active = active
        super().exchange(pairs, tag=tag, nbytes=nbytes, comm=comm,
                         deliver=deliver)

    def _filter_arrivals(self, pairs, arr, tag, nbytes, comm):
        """``Fabric.arrival_filter`` hook: the non-permutation rewrites
        (called once per exchange by the validated base ``exchange``,
        with ``arr`` already resolved from ``deliver``)."""
        active = self._active
        if not active:
            return arr
        x = self._x - 1               # index of the exchange in flight
        rng = self._frng
        out = arr
        for spec in active:
            kind = spec.kind
            if kind == "drop":
                kept = []
                n = 0
                want = spec.rank
                rate = spec.rate
                rule = self._rules.get("drop")
                for p in out:
                    if (want < 0 or p[0] == want) \
                            and rng.random() < rate:
                        n += 1
                        if rule is not None:
                            self._schedule_retransmit(
                                rule, x, 0, rate, p[0], p[1], tag,
                                nbytes, comm)
                    else:
                        kept.append(p)
                if n:
                    out = kept
                    self._note(spec, x, n)
                    if rule is not None:
                        self._note_rcv("rtx", x, n, want)
            elif kind == "duplicate":
                dup = []
                n = 0
                nsup = 0
                want = spec.rank
                rate = spec.rate
                suppress = "duplicate" in self._rules
                for p in out:
                    dup.append(p)
                    if (want < 0 or p[0] == want) \
                            and rng.random() < rate:
                        if suppress:
                            # the copy reuses its original's channel
                            # sequence number: the receiver's dedup
                            # window discards it before the engine
                            # can park it
                            nsup += 1
                            self._lane(p[1]).count(EV_SUPPRESSED, 1)
                        else:
                            dup.append(p)
                            n += 1
                if n:
                    out = dup
                    self._note(spec, x, n)
                elif nsup:
                    self._note(spec, x, nsup)
                    self._note_rcv("suppress", x, nsup, want)
            elif kind == "delay":
                kept = []
                n = 0
                want = spec.rank
                due = x + spec.hold
                for p in out:
                    if p[0] == want:
                        self._deferred.append(
                            (due, p[0], p[1], tag, nbytes, comm))
                        n += 1
                    else:
                        kept.append(p)
                if n:
                    out = kept
                    # injector-side evidence on the straggler's lane —
                    # the live signal straggler_rank keys on
                    (self.reg.lane(want) if self.per_rank_lanes
                     else self.reg).count("fault.delay.deferred", n)
                    self._note(spec, x, n)
            elif kind == "reorder":
                m = len(out)
                if m > 1:
                    # bounded-displacement shuffle: stable sort by
                    # i + U{0..k} moves no arrival more than k slots
                    keyed = sorted(
                        (i + rng.randrange(spec.k + 1), i)
                        for i in range(m))
                    out = [out[i] for _, i in keyed]
                    self._note(spec, x, m)
            elif kind == "rank_leave":
                n0 = len(out)
                kept = [p for p in out if p[0] != spec.rank]
                if len(kept) != n0:
                    out = kept        # in-flight sends die with the rank
                    self._note(spec, x, n0 - len(kept))
        return out

    # -- delayed-delivery plumbing -----------------------------------------

    def _release_due(self, x: int) -> None:
        """Deliver every deferred arrival due at or before exchange
        ``x``, ahead of that exchange's own traffic."""
        dq = self._deferred
        due = [e for e in dq if e[0] <= x]
        if not due:
            return
        self._deferred = deque(e for e in dq if e[0] > x)
        for _, src, dst, tag, nb, comm in due:
            self._deliver_direct(src, dst, tag, nb, comm)

    # -- recovery plumbing (repro_torch.faults.recovery) -------------------------

    def _lane(self, pid: int):
        return self.reg.lane(pid) if self.per_rank_lanes else self.reg

    def _schedule_retransmit(self, rule: RecoveryRule, x: int,
                             attempt: int, rate: float, src: int,
                             dst: int, tag: int, nb: int,
                             comm: int) -> None:
        """Queue transmission attempt ``attempt`` (0 = first
        retransmit after the original drop) of one lost delivery;
        the timeout/backoff/jitter schedule is the rule's."""
        due = x + rule.delay(attempt, self._rrng)
        self._retrans.append((due, attempt + 1, rate, src, dst, tag,
                              nb, comm))

    def _release_retrans(self, x: int) -> None:
        """Deliver — or lose again, bounded by ``max_retries`` —
        every retransmit due at or before exchange ``x``, ahead of
        that exchange's own traffic. Past the retry bound the modeled
        reliable channel always delivers, so recovery converges."""
        dq = self._retrans
        due = [e for e in dq if e[0] <= x]
        if not due:
            return
        self._retrans = deque(e for e in dq if e[0] > x)
        rrng = self._rrng
        rule = self._rules["drop"]
        ndel = nretry = 0
        for _, attempt, rate, src, dst, tag, nb, comm in due:
            if attempt <= rule.max_retries and rrng.random() < rate:
                # the retransmit was lost too: back off and go again
                nretry += 1
                self._lane(dst).count(EV_RETRY, 1)
                self._schedule_retransmit(rule, x, attempt, rate,
                                          src, dst, tag, nb, comm)
            else:
                ndel += 1
                self._lane(dst).count(EV_RETRANSMIT, 1)
                self._deliver_direct(src, dst, tag, nb, comm)
        if nretry:
            self._note_rcv("retry", x, nretry, -1)
        if ndel:
            self._note_rcv("deliver", x, ndel, -1)

    def _deliver_direct(self, src: int, dst: int, tag: int, nb: int,
                        comm: int) -> None:
        """One out-of-band arrival, fuse-aware: inside a fused span the
        op joins the destination engine's accumulated stream (keeping
        traced and untraced stats identical); otherwise it dispatches
        immediately."""
        fuse = self._fuse
        if fuse is not None:
            grp = fuse.get(dst)
            if grp is None:
                grp = fuse[dst] = []
            grp += (False, src, tag, nb, comm)
        else:
            self.engine(dst).arrive(src, tag, comm, nb)

    def finish(self) -> None:
        """Flush all still-deferred arrivals and still-pending
        retransmits (call once, after the scenario's drive loop):
        straggler and retransmitted messages land late, they do not
        vanish — a delayed or recovering run ends balanced."""
        dq = self._deferred
        if dq:
            self._deferred = deque()
            if self.trace is not None:
                self.trace.emit({"t": "flt", "kind": "delay",
                                 "x": self._x, "n": len(dq),
                                 "flush": 1})
            for _, src, dst, tag, nb, comm in dq:
                self._deliver_direct(src, dst, tag, nb, comm)
        rt = self._retrans
        if rt:
            # end-of-run reliable flush: whatever the retry schedule
            # still holds is delivered now, so a recovering run always
            # converges to zero net orphan posts
            self._retrans = deque()
            self._note_rcv("flush", self._x, len(rt), -1)
            for _, _, _, src, dst, tag, nb, comm in rt:
                self._lane(dst).count(EV_RETRANSMIT, 1)
                self._deliver_direct(src, dst, tag, nb, comm)

    # -- trace annotation --------------------------------------------------

    def _note(self, spec: FaultSpec, x: int, n: int) -> None:
        """One ``flt`` record per (exchange, spec) that fired."""
        if self.trace is not None:
            self.trace.emit({"t": "flt", "kind": spec.kind, "x": x,
                             "n": n, "rank": spec.rank})

    def _note_rcv(self, act: str, x: int, n: int, rank: int) -> None:
        """One bare ``rcv`` record per (exchange, recovery action) —
        annotation only, like ``flt``: the healed op stream itself is
        carried by the ordinary post/arr records, so recovering traces
        replay and convert (v2 <-> v3 byte-identical) unchanged."""
        if self.trace is not None:
            self.trace.emit({"t": "rcv", "act": act, "x": x, "n": n,
                             "rank": rank})


def build_faulty(plan: Optional[FaultPlan],
                 recovery: Optional[RecoveryPolicy] = None,
                 **kw) -> Fabric:
    """Fabric factory: a plain :class:`Fabric` when ``plan`` is falsy
    (no plan / no specs — nothing to recover from either), else a
    :class:`FaultyFabric`, self-healing when ``recovery`` is set."""
    if plan is None or not plan.specs:
        return Fabric(**kw)
    return FaultyFabric(plan, recovery=recovery, **kw)


def finish_faults(fab: Fabric) -> None:
    """Flush a fabric's deferred fault deliveries if it has any (no-op
    for a healthy fabric) — run-harness convenience."""
    fin = getattr(fab, "finish", None)
    if fin is not None:
        fin()
