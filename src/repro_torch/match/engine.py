"""Two-queue message-matching engine (paper method 2).

An MPI implementation matches every incoming message against the *posted-
receive queue* (PRQ) and parks early arrivals on the *unexpected-message
queue* (UMQ). The envelope is ``(src, tag, comm)`` with MPI wildcard
semantics (``ANY_SOURCE`` / ``ANY_TAG``) and the non-overtaking rule:
among the posted receives that match a message, the *earliest posted*
wins; among unexpected messages that match a receive, the *earliest
arrived* wins.

This module is the host-level model of that engine, instrumented with the
lightweight counters the paper adds to the matching path (queue depth
traversed, queue length at post time, match latency, unexpected counts)
via :class:`repro_torch.core.counters.CounterRegistry`. The engine writes its
counter deltas with one buffer fetch and one batched append per op
(:meth:`CounterRegistry.buffer`), so instrumentation cost does not
dominate the path it instruments — the property the paper calls out as
essential for counters inside the critical path.

Engine modes (see :mod:`repro_torch.match.defects` for the seeded defects):

  * ``"binned"``    — the fixed design: the PRQ is binned by envelope
    (specific / any-source / any-tag / any-any), so a match examines at
    most four queue heads; the UMQ is envelope-indexed
    (:class:`IndexedUMQ`), so specific receives find their message in
    O(1) and every consumed entry is reclaimed immediately.
  * ``"linear"``    — seeded defect 1: one flat PRQ searched linearly.
  * ``"leaky_umq"`` — seeded defect 2: UMQ entries consumed via wildcard
    receives are tombstoned, never reclaimed.

:class:`Fabric` models a set of ranks (one engine each) and decomposes
collectives into the point-to-point messages an implementation like
ExaMPI issues, with a deterministic interleave that produces both
expected and unexpected arrivals and occasional wildcard receives — the
traffic mix the paper's histograms are drawn from.

A copy of ``repro.match.engine``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Tuple

try:                                  # optional: the vectorized wildcard
    import numpy as _np               # filter and plan makers fall back
except ImportError:                   # to the pure-python paths without it
    _np = None

from ..comm import patterns
from ..core.counters import CounterRegistry, global_registry

ANY_SOURCE = -1
ANY_TAG = -1

MODES = ("binned", "linear", "leaky_umq")
# "fifo" is the flat FIFO-per-envelope view of the fixed design — accepted
# wherever a mode is taken (benchmarks/replay_sweep.py uses it).
MODE_ALIASES = {"fifo": "binned"}

# Search latency (match.prq.search_ns / match.umq.search_ns) is sampled:
# every TIMING_EVERY-th op per engine is timed and its measurement is
# scaled by the period, so totals — what roofline.match_seconds, finding
# severities and the trace differ consume — stay calibrated while the
# per-op cost of two perf_counter_ns() calls is paid once per
# TIMING_EVERY ops.
# The first op on every engine is always sampled (tiny workloads still
# get a measurement). Search times are wall-clock and therefore already
# excluded from deterministic traces and baseline-gated metrics.
TIMING_EVERY = 64

_pcn = time.perf_counter_ns

_NULL_CONTEXT = contextlib.nullcontext()

# Column specs for the batched counter sink (see repro_torch.core.counters
# COLS records): each batched op appends one row of values; the delta
# multiset is identical to the per-op quads.
_POST_HIT_COLS = (("match.umq.length", True),
                  ("match.umq.traversal_depth", True),
                  ("match.umq.hit", False))
_POST_MISS_COLS = (("match.umq.length", True),
                   ("match.umq.traversal_depth", True),
                   ("match.prq.length", True))
_ARR_EXP_COLS = (("match.prq.traversal_depth", True),
                 ("match.expected", False))
_ARR_UNEXP_COLS = (("match.prq.traversal_depth", True),
                   ("match.unexpected", False),
                   ("match.umq.length", True))


class _FusedSpan:
    """Reentrant context tracking an untraced fused dispatch span on one
    fabric: enclosed exchanges accumulate per-engine op streams instead
    of dispatching, and the outermost exit flushes each engine's stream
    through :meth:`MatchEngine.run_ops` (one python dispatch per engine
    per span). One instance per fabric — nesting is a depth counter."""

    __slots__ = ("fab",)

    def __init__(self, fab: "Fabric"):
        self.fab = fab

    def __enter__(self) -> "Fabric":
        fab = self.fab
        fab._depth += 1
        if fab._fuse is None:
            fab._fuse = {}
        return fab

    def __exit__(self, *exc) -> None:
        fab = self.fab
        fab._depth -= 1
        if fab._depth == 0:
            fuse, fab._fuse = fab._fuse, None
            for dst, ops in fuse.items():
                fab.engine(dst).run_ops(ops)


# Exchange-plan cache (module-global: plans are pure values — per-
# destination op groups — keyed by pattern-tuple identity, the
# unexpected/wildcard mix, the tick phase and the envelope, so every
# fabric a bench or sweep builds shares one warm cache). Each plan pins
# the tuples it was built from, which is what keeps its id()-based key
# valid: a live pin means no other object can hold that id.
_PLAN_CACHE: Dict = {}
_PLAN_CACHE_MAX = 8192


def _group_np(dsts, srcs) -> Tuple:
    """Group a phase's (dst, src) columns by destination in one numpy
    pass: stable-sort on dst, cut at the boundaries, return
    ``((dst, [src, ...]), ...)`` ordered by destination rank with each
    group's srcs in original (pair) order — the same groups the
    pure-python grouping loop produces."""
    n = len(dsts)
    if not n:
        return ()
    order = _np.argsort(dsts, kind="stable")
    sd = dsts[order]
    ss = srcs[order].tolist()
    cuts = _np.flatnonzero(sd[1:] != sd[:-1]) + 1
    out = []
    start = 0
    for end in (*cuts.tolist(), n):
        out.append((int(sd[start]), ss[start:end]))
        start = end
    return tuple(out)


def canonical_mode(mode: str) -> str:
    """Resolve aliases and validate an engine mode name."""
    mode = MODE_ALIASES.get(mode, mode)
    if mode not in MODES:
        raise ValueError(
            f"mode must be one of {MODES} (or aliases "
            f"{tuple(MODE_ALIASES)}), got {mode!r}")
    return mode


class Message:
    """An arrived message's envelope (plus payload size)."""

    __slots__ = ("src", "tag", "comm", "nbytes", "seq", "matched")

    def __init__(self, src: int, tag: int, comm: int = 0, nbytes: int = 0,
                 seq: int = 0, matched: bool = False):
        self.src = src
        self.tag = tag
        self.comm = comm
        self.nbytes = nbytes
        self.seq = seq                # arrival order
        self.matched = matched        # tombstone flag (leaky UMQ defect)

    def __repr__(self) -> str:
        return (f"Message(src={self.src}, tag={self.tag}, "
                f"comm={self.comm}, nbytes={self.nbytes}, "
                f"seq={self.seq}, "
                f"matched={getattr(self, 'matched', False)})")


class PostedRecv:
    """A posted receive; completed once a message is matched to it."""

    __slots__ = ("src", "tag", "comm", "seq", "message")

    def __init__(self, src: int, tag: int, comm: int = 0, seq: int = 0,
                 message: Optional[Message] = None):
        self.src = src
        self.tag = tag
        self.comm = comm
        self.seq = seq                # post order
        self.message = message

    @property
    def completed(self) -> bool:
        return self.message is not None

    @property
    def wildcard(self) -> bool:
        return self.src == ANY_SOURCE or self.tag == ANY_TAG

    def accepts(self, msg: Message) -> bool:
        return (self.comm == msg.comm
                and self.src in (ANY_SOURCE, msg.src)
                and self.tag in (ANY_TAG, msg.tag))

    def __repr__(self) -> str:
        return (f"PostedRecv(src={self.src}, tag={self.tag}, "
                f"comm={self.comm}, seq={self.seq}, "
                f"completed={self.message is not None})")


class BinnedPRQ:
    """Fixed posted-receive queue: binned by envelope shape so matching an
    arrival examines at most four queue heads (specific, any-source,
    any-tag, any-any), while seq numbers preserve MPI post order.

    The specific bins nest as ``(tag, comm) -> {src: deque}``: batch
    dispatch (:meth:`MatchEngine.arrive_batch`) delivers whole phases at
    one ``(tag, comm)``, so the outer lookup hoists out of the
    per-message loop and the inner probe is a plain int-keyed get with
    no tuple allocation."""

    def __init__(self) -> None:
        self._specific: Dict[Tuple[int, int],
                             Dict[int, Deque[PostedRecv]]] = {}
        self._any_src: Dict[Tuple[int, int], Deque[PostedRecv]] = {}
        self._any_tag: Dict[Tuple[int, int], Deque[PostedRecv]] = {}
        self._any_any: Dict[int, Deque[PostedRecv]] = {}     # keyed by comm
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def post(self, recv: PostedRecv) -> None:
        src, tag = recv.src, recv.tag
        if src == ANY_SOURCE:
            bins = self._any_any if tag == ANY_TAG else self._any_src
            key = recv.comm if tag == ANY_TAG else (tag, recv.comm)
            q = bins.get(key)
            if q is None:
                q = bins[key] = deque()
        elif tag == ANY_TAG:
            bins, key = self._any_tag, (src, recv.comm)
            q = bins.get(key)
            if q is None:
                q = bins[key] = deque()
        else:
            per = self._specific.get((tag, recv.comm))
            if per is None:
                per = self._specific[(tag, recv.comm)] = {}
            q = per.get(src)
            if q is None:
                q = per[src] = deque()
        q.append(recv)
        self._len += 1

    def match(self, msg: Message) -> Tuple[Optional[PostedRecv], int]:
        """(matched recv or None, queue heads examined). Emptied bins are
        deleted so the wildcard probes below stay O(1) dict-emptiness
        checks in wildcard-free traffic."""
        comm = msg.comm
        depth = 0
        best: Optional[PostedRecv] = None
        best_bins = best_key = None
        bins = self._specific
        if bins:
            per = bins.get((msg.tag, comm))
            if per:
                q = per.get(msg.src)
                if q:
                    depth = 1
                    best, best_bins, best_key = q[0], per, msg.src
        bins = self._any_src
        if bins:
            key = (msg.tag, comm)
            q = bins.get(key)
            if q:
                depth += 1
                head = q[0]
                if best is None or head.seq < best.seq:
                    best, best_bins, best_key = head, bins, key
        bins = self._any_tag
        if bins:
            key = (msg.src, comm)
            q = bins.get(key)
            if q:
                depth += 1
                head = q[0]
                if best is None or head.seq < best.seq:
                    best, best_bins, best_key = head, bins, key
        bins = self._any_any
        if bins:
            q = bins.get(comm)
            if q:
                depth += 1
                head = q[0]
                if best is None or head.seq < best.seq:
                    best, best_bins, best_key = head, bins, comm
        if best is not None:
            q = best_bins[best_key]
            q.popleft()
            if not q:
                del best_bins[best_key]
            self._len -= 1
        return best, depth if depth > 1 else 1


class IndexedUMQ:
    """Fixed unexpected-message queue: envelope-indexed and reclaimed on
    every match, mirroring :class:`BinnedPRQ`'s binning on the message
    side.

    The queue keeps the arrival-ordered list of live messages (the
    structure the depth counters are defined over) plus an exact-envelope
    index ``(src, tag, comm) -> deque``. A *specific* receive finds its
    message in O(1) off the index — the arrival list is then only probed
    with a C-level identity scan (``list.index``; :class:`Message` has
    default identity equality) to report the true arrival rank and drop
    the entry, instead of a Python-level ``accepts`` scan per queue
    entry. A receive whose envelope misses the index costs O(1) — no
    scan at all, which is the common case on the post-before-arrival
    path. *Wildcard* receives traverse the arrival list (specialized per
    wildcard shape) and report true depth, exactly like the single-queue
    design.

    **Depth contract**: ``match`` reports exactly what a front-to-back
    scan of one arrival-ordered queue reports — on a hit, the matched
    message's 1-based rank among live messages in arrival order; on a
    miss, the live queue length — which keeps the
    ``match.umq.traversal_depth`` histogram (and therefore deterministic
    traces and committed baselines) byte-identical to the pre-indexed
    engine.

    Deep wildcard traversals additionally vectorize: parallel numpy
    envelope columns (src / tag / comm), maintained lazily alongside
    the arrival list, let a wildcard receive over a long queue resolve
    as one boolean-mask ``argmax`` instead of a python attribute scan.
    A short python prefix scan runs first so the depth-1 hit — the
    fixed design's common case — never pays the vectorization setup.
    The columns are pure acceleration structure: hit index and depth
    are exactly what the linear scan reports, and when numpy is absent
    the original scan is the code path."""

    __slots__ = ("_q", "_env", "_lazy", "_cols", "_coff", "_cvalid",
                 "_ccap")

    # Vectorization thresholds (class attributes so tests can force
    # either path): queues shorter than _VEC_MIN stay on the python
    # scan; longer queues scan the first _SCAN_PREFIX entries in python
    # (early-exit protection) before masking the remainder.
    _VEC_MIN = 48
    _SCAN_PREFIX = 16
    _MIN_CAP = 128

    def __init__(self) -> None:
        self._q: List[Message] = []     # live messages, arrival order
        # (tag, comm) -> {src: deque}; built LAZILY: arrivals are plain
        # appends (the suffix _q[-_lazy:] is not yet indexed), and the
        # index catches up only when a specific receive probes it. A
        # workload whose unexpected messages are consumed by wildcards
        # never pays for the index at all.
        self._env: Dict[Tuple[int, int], Dict[int, Deque[Message]]] = {}
        self._lazy = 0                  # unindexed arrival-suffix length
        # numpy envelope columns, also lazy: _cols[k][_coff:_coff+_cvalid]
        # mirrors (src, tag, comm) of _q[:_cvalid]. _coff counts dead
        # leading entries (head deletions advance the window instead of
        # shifting the arrays); a mid-queue deletion truncates _cvalid
        # to the deletion point. While _cvalid == 0 the columns cost one
        # integer compare per deletion and nothing per arrival.
        self._cols = None
        self._coff = 0
        self._cvalid = 0
        self._ccap = 0

    def __len__(self) -> int:
        return len(self._q)

    def add(self, msg: Message) -> None:
        self._q.append(msg)
        self._lazy += 1

    def _flush_index(self) -> None:
        """Index the unindexed arrival suffix (amortized O(1)/message:
        each message is indexed at most once)."""
        q = self._q
        env = self._env
        for m in q[len(q) - self._lazy:]:
            key = (m.tag, m.comm)
            per = env.get(key)
            if per is None:
                per = env[key] = {}
            dq = per.get(m.src)
            if dq is None:
                dq = per[m.src] = deque()
            dq.append(m)
        self._lazy = 0

    def note_del(self, i: int) -> None:
        """Column maintenance for a deletion of ``_q[i]`` (inlined batch
        fast paths delete directly off the raw list). O(1), and a single
        compare while no columns exist (``_cvalid == 0``)."""
        if i < self._cvalid:
            if i:
                self._cvalid = i        # suffix shifted: revalidate lazily
            else:
                self._cvalid -= 1       # head pop: advance the window
                self._coff += 1

    def _sync_cols(self) -> None:
        """Bring the envelope columns up to date with ``_q`` (extend the
        valid prefix; grow — and compact the dead head — when out of
        capacity)."""
        q = self._q
        n = len(q)
        v = self._cvalid
        if self._cols is None or self._coff + n > self._ccap:
            cap = max(self._MIN_CAP, 2 * n)
            cols = (_np.empty(cap, _np.int64),
                    _np.empty(cap, _np.int64),
                    _np.empty(cap, _np.int64))
            if v:
                off = self._coff
                for new, old in zip(cols, self._cols):
                    new[:v] = old[off:off + v]
            self._cols = cols
            self._ccap = cap
            self._coff = 0
        if v < n:
            lo = self._coff + v
            hi = self._coff + n
            tail = q[v:]
            cs, ct, cc = self._cols
            cs[lo:hi] = [m.src for m in tail]
            ct[lo:hi] = [m.tag for m in tail]
            cc[lo:hi] = [m.comm for m in tail]
            self._cvalid = n

    def _hybrid_find(self, src: int, tag: int, comm: int) -> int:
        """Wildcard candidate search over a long queue: python scan of
        the first ``_SCAN_PREFIX`` arrivals (depth-1 hits stay cheap),
        then one numpy boolean mask over the remaining envelope columns;
        ``argmax`` of the mask is the earliest acceptable arrival.
        Returns the 0-based queue index, or -1 on a miss."""
        q = self._q
        n = len(q)
        pre = self._SCAN_PREFIX
        if pre > n:
            pre = n
        for j in range(pre):
            m = q[j]
            if ((src == ANY_SOURCE or m.src == src)
                    and (tag == ANY_TAG or m.tag == tag)
                    and m.comm == comm):
                return j
        if pre == n:
            return -1
        self._sync_cols()
        lo = self._coff + pre
        hi = self._coff + len(q)
        cs, ct, cc = self._cols
        if src == ANY_SOURCE:
            if tag == ANY_TAG:
                mask = cc[lo:hi] == comm
            else:
                mask = (ct[lo:hi] == tag) & (cc[lo:hi] == comm)
        else:
            mask = (cs[lo:hi] == src) & (cc[lo:hi] == comm)
        j = int(mask.argmax())
        if not mask[j]:
            return -1
        return pre + j

    def match(self, recv: PostedRecv) -> Tuple[Optional[Message], int]:
        return self.match_env(recv.src, recv.tag, recv.comm)

    def match_env(self, src: int, tag: int,
                  comm: int = 0) -> Tuple[Optional[Message], int]:
        """:meth:`match` by raw envelope — batch dispatch uses this to
        decide hit/miss before allocating a receive that would complete
        immediately and never escape."""
        q = self._q
        if src != ANY_SOURCE and tag != ANY_TAG:
            if self._lazy:
                self._flush_index()
            per = self._env.get((tag, comm))
            dq = per.get(src) if per else None
            if not dq:
                return None, len(q)
            msg = dq.popleft()          # earliest same-envelope arrival
            if not dq:
                del per[src]
            i = q.index(msg)            # identity scan: true rank
            self.note_del(i)
            del q[i]
            return msg, i + 1
        # wildcard receive: traverse arrival order (earliest accepted
        # arrival wins) — numpy envelope-column filter for long queues,
        # python scan specialized per wildcard shape otherwise
        if _np is not None and len(q) >= self._VEC_MIN:
            i = self._hybrid_find(src, tag, comm)
        else:
            i = -1
            if src == ANY_SOURCE:
                if tag == ANY_TAG:
                    for j, m in enumerate(q):
                        if m.comm == comm:
                            i = j
                            break
                else:
                    for j, m in enumerate(q):
                        if m.tag == tag and m.comm == comm:
                            i = j
                            break
            else:
                for j, m in enumerate(q):
                    if m.src == src and m.comm == comm:
                        i = j
                        break
        if i < 0:
            return None, len(q)
        msg = q[i]
        indexed = i < len(q) - self._lazy
        self.note_del(i)
        del q[i]
        if not indexed:
            self._lazy -= 1             # was still in the lazy suffix
        else:
            per = self._env[(msg.tag, msg.comm)]
            dq = per[msg.src]
            dq.popleft()                # msg is its bucket's earliest
            if not dq:
                del per[msg.src]
        return msg, i + 1


# Backward-compatible name: the garbage-collected UMQ of the fixed design
# is now envelope-indexed; semantics (and reported depths) are identical.
GCUMQ = IndexedUMQ


class MatchEngine:
    """One rank's matching engine: PRQ + UMQ + counters.

    ``post_recv`` is the MPI_Irecv analog (search UMQ, else park on PRQ);
    ``arrive`` is the network-delivery analog (search PRQ, else park on
    UMQ). Every call records the counters the paper's method 2 plots:
    traversal depth, queue length, match latency, unexpected counts —
    written as one batched append to the registry's thread-local buffer
    so the instrumentation stays off the critical path's critical path.

    ``trace`` is an optional sink with an ``emit(dict)`` method (duck-typed
    to avoid a dependency on :mod:`repro.trace`): every post/arrive writes
    one schema record carrying the envelope, the per-engine sequence number
    and the match outcome, which is what the offline replayer re-drives.
    """

    def __init__(self, rank: int = 0, mode: str = "binned",
                 registry: Optional[CounterRegistry] = None,
                 trace=None):
        from .defects import LeakyUMQ, LinearPRQ
        mode = canonical_mode(mode)
        self.rank = rank
        self.mode = mode
        self.reg = registry if registry is not None else global_registry()
        self.trace = trace
        self.prq = LinearPRQ() if mode == "linear" else BinnedPRQ()
        self.umq = (LeakyUMQ(self.reg) if mode == "leaky_umq"
                    else IndexedUMQ())
        self._seqn = 0                # next per-engine op sequence number
        # hot-path counter sink: the underlying registry (self.reg may be
        # a per-rank CounterLane view of it), the lane pid, and a cached
        # thread-buffer reference revalidated against the registry epoch
        # (a drain on this thread swaps the buffer out and bumps it)
        self._reg = getattr(self.reg, "_reg", self.reg)
        self._pid = self.reg.pid
        self._buf: Optional[list] = None
        self._epoch = -1
        self._tsample = 1             # ops until the next timed sample

    # -- MPI_Irecv analog --------------------------------------------------

    def post_recv(self, src: int = ANY_SOURCE, tag: int = ANY_TAG,
                  comm: int = 0) -> PostedRecv:
        sq = self._seqn
        self._seqn = sq + 1
        recv = PostedRecv(src, tag, comm, sq)
        umq = self.umq
        reg = self._reg
        if reg.enabled:
            if reg.epoch != self._epoch:
                self._buf = reg._buffer_for_current_thread()
                self._epoch = reg.epoch
            buf = self._buf
            pid = self._pid
            ulen = len(umq._q)
            t = self._tsample - 1
            if t:                     # untimed op (see TIMING_EVERY)
                self._tsample = t
                msg, depth = umq.match(recv)
                if msg is not None:
                    recv.message = msg
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.umq.hit", 1, False)
                else:
                    prq = self.prq
                    plen = prq._len
                    prq.post(recv)
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.prq.length", plen, True)
            else:
                self._tsample = TIMING_EVERY
                t0 = _pcn()
                msg, depth = umq.match(recv)
                sns = (_pcn() - t0) * TIMING_EVERY
                if msg is not None:
                    recv.message = msg
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.umq.hit", 1, False,
                            pid, "match.umq.search_ns", sns, True)
                else:
                    prq = self.prq
                    plen = prq._len
                    prq.post(recv)
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.prq.length", plen, True,
                            pid, "match.umq.search_ns", sns, True)
        else:
            msg, depth = umq.match(recv)
            if msg is not None:
                recv.message = msg
            else:
                self.prq.post(recv)
        if self.trace is not None:
            self.trace.emit({
                "t": "post", "rank": self.rank, "src": src, "tag": tag,
                "comm": comm, "seq": recv.seq,
                "hit": msg.seq if msg is not None else None})
        return recv

    def post_recv_batch(self, srcs, tag: int = ANY_TAG,
                        comm: int = 0) -> None:
        """Post one receive per source in ``srcs`` (a shared ``tag`` —
        the :meth:`Fabric.exchange` shape), equivalent to calling
        :meth:`post_recv` per element: same matching, same counter
        multiset, same sampling cadence. The batch loop pays the python
        dispatch (call, buffer fetch, queue attribute loads) once and
        inlines the binned-mode fast paths; it falls back to the per-op
        path whenever tracing is on (trace records must interleave
        globally across engines in dispatch order) or a defect mode's
        queues are in play (their pathological cost is the product)."""
        reg = self._reg
        if (self.trace is not None or self.mode != "binned"
                or not reg.enabled):
            for src in srcs:
                self.post_recv(src, tag, comm)
            return
        if reg.epoch != self._epoch:
            self._buf = reg._buffer_for_current_thread()
            self._epoch = reg.epoch
        buf = self._buf
        pid = self._pid
        sq = self._seqn
        tsample = self._tsample
        umq = self.umq
        uq = umq._q
        tc = (tag, comm)
        spectag = tag != ANY_TAG
        if spectag and umq._lazy:
            umq._flush_index()          # no arrivals run in this batch
        uenv_tc = umq._env.get(tc) if spectag else None
        prq = self.prq
        spec_tc = asrc_q = None         # bound lazily on first park
        new = PostedRecv.__new__
        hitv = missv = None
        # queue lengths mirrored in locals for the batch (written back
        # once): no arrivals run here, so only our own hits/parks move
        # them
        ulen = len(uq)
        plen = prq._len
        for src in srcs:
            sq += 1                   # this op's seq is sq - 1
            tsample -= 1
            sns = -1                  # untimed op
            if tsample:
                if spectag and src != ANY_SOURCE:
                    # specific receive: probe the envelope index — a
                    # miss costs O(1); a hit is resolved inline, and the
                    # receive (which completes immediately and never
                    # escapes this batch) is not allocated at all
                    dq = uenv_tc.get(src) if uenv_tc else None
                    if dq:
                        msg = dq.popleft()
                        if not dq:
                            del uenv_tc[src]
                        i = uq.index(msg)
                        if i < umq._cvalid:
                            umq.note_del(i)
                        del uq[i]
                        depth = i + 1
                    else:
                        msg, depth = None, ulen
                else:
                    msg, depth = umq.match_env(src, tag, comm)
            else:
                tsample = TIMING_EVERY
                t0 = _pcn()
                msg, depth = umq.match_env(src, tag, comm)
                sns = (_pcn() - t0) * TIMING_EVERY
            if msg is not None:
                if sns >= 0:
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.umq.hit", 1, False,
                            pid, "match.umq.search_ns", sns, True)
                else:
                    if hitv is None:
                        hitv = []
                    hitv += (ulen, depth, 1)
                ulen -= 1             # recorded length was pre-match
            else:
                recv = new(PostedRecv)
                recv.src = src
                recv.tag = tag
                recv.comm = comm
                recv.seq = sq - 1
                recv.message = None
                # BinnedPRQ.post inlined; specific/any-src bin dicts for
                # the batch's fixed (tag, comm) bound on first use
                if src == ANY_SOURCE or not spectag:
                    if spectag:
                        if asrc_q is None:
                            asrc = prq._any_src
                            asrc_q = asrc.get(tc)
                            if asrc_q is None:
                                asrc_q = asrc[tc] = deque()
                        asrc_q.append(recv)
                    else:
                        prq.post(recv)      # ANY_TAG shapes: generic
                        prq._len -= 1       # the mirror owns the count
                else:
                    if spec_tc is None:
                        spec = prq._specific
                        spec_tc = spec.get(tc)
                        if spec_tc is None:
                            spec_tc = spec[tc] = {}
                    bq = spec_tc.get(src)
                    if bq is None:
                        bq = spec_tc[src] = deque()
                    bq.append(recv)
                if sns >= 0:
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.prq.length", plen, True,
                            pid, "match.umq.search_ns", sns, True)
                else:
                    if missv is None:
                        missv = []
                    missv += (ulen, depth, plen)
                plen += 1
        prq._len = plen
        if hitv:
            buf += (pid, _POST_HIT_COLS, hitv, "cols")
        if missv:
            buf += (pid, _POST_MISS_COLS, missv, "cols")
        self._seqn = sq
        self._tsample = tsample

    # -- network delivery analog ------------------------------------------

    def arrive(self, src: int, tag: int, comm: int = 0,
               nbytes: int = 0) -> Optional[PostedRecv]:
        sq = self._seqn
        self._seqn = sq + 1
        msg = Message(src, tag, comm, nbytes, sq)
        reg = self._reg
        if reg.enabled:
            if reg.epoch != self._epoch:
                self._buf = reg._buffer_for_current_thread()
                self._epoch = reg.epoch
            buf = self._buf
            pid = self._pid
            t = self._tsample - 1
            if t:                     # untimed op (see TIMING_EVERY)
                self._tsample = t
                recv, depth = self.prq.match(msg)
                if recv is not None:
                    recv.message = msg
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.expected", 1, False)
                else:
                    umq = self.umq
                    umq.add(msg)
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.unexpected", 1, False,
                            pid, "match.umq.length", len(umq._q), True)
            else:
                self._tsample = TIMING_EVERY
                t0 = _pcn()
                recv, depth = self.prq.match(msg)
                sns = (_pcn() - t0) * TIMING_EVERY
                if recv is not None:
                    recv.message = msg
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.expected", 1, False)
                else:
                    umq = self.umq
                    umq.add(msg)
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.unexpected", 1, False,
                            pid, "match.umq.length", len(umq._q), True)
        else:
            recv, depth = self.prq.match(msg)
            if recv is not None:
                recv.message = msg
            else:
                self.umq.add(msg)
        if self.trace is not None:
            self.trace.emit({
                "t": "arr", "rank": self.rank, "src": src, "tag": tag,
                "comm": comm, "nb": nbytes, "seq": msg.seq,
                "match": recv.seq if recv is not None else None})
        return recv

    def arrive_batch(self, srcs, tag: int = 0, comm: int = 0,
                     nbytes: int = 0) -> None:
        """Deliver one message per source in ``srcs`` (shared ``tag`` /
        ``nbytes`` — the :meth:`Fabric.exchange` shape), equivalent to
        calling :meth:`arrive` per element: same matching, same counter
        multiset, same sampling cadence. The binned PRQ's four-bin probe
        is inlined with the bin dicts bound once per batch; the per-op
        fallback applies under tracing or a defect mode (see
        :meth:`post_recv_batch`)."""
        reg = self._reg
        if (self.trace is not None or self.mode != "binned"
                or not reg.enabled):
            for src in srcs:
                self.arrive(src, tag, comm, nbytes)
            return
        if reg.epoch != self._epoch:
            self._buf = reg._buffer_for_current_thread()
            self._epoch = reg.epoch
        buf = self._buf
        pid = self._pid
        sq = self._seqn
        tsample = self._tsample
        umq = self.umq
        uq = umq._q
        tc = (tag, comm)
        prq = self.prq
        # a whole arrival phase shares (tag, comm): the specific inner
        # bin dict hoists out of the loop (no posts run here, so a None
        # stays None and empties empty in place)
        spec_tc = prq._specific.get(tc)
        asrc = prq._any_src
        atag = prq._any_tag
        aany = prq._any_any
        new = Message.__new__
        expv = unexv = None
        ulen = len(uq)                  # mirrored for the batch
        nmatched = 0
        for src in srcs:
            msg = new(Message)
            msg.src = src
            msg.tag = tag
            msg.comm = comm
            msg.nbytes = nbytes
            msg.seq = sq
            sq += 1
            tsample -= 1
            if not tsample:
                tsample = TIMING_EVERY
                t0 = _pcn()
                recv, depth = prq.match(msg)
                sns = (_pcn() - t0) * TIMING_EVERY
                if recv is not None:
                    recv.message = msg
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.expected", 1, False)
                else:
                    umq.add(msg)
                    ulen += 1
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.unexpected", 1, False,
                            pid, "match.umq.length", ulen, True)
                continue
            # untimed op: BinnedPRQ.match inlined (bins are locals)
            depth = 0
            best = best_bins = best_key = None
            if spec_tc:
                q = spec_tc.get(src)
                if q:
                    depth = 1
                    best, best_bins, best_key = q[0], spec_tc, src
            if asrc:
                q = asrc.get(tc)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, asrc, tc
            if atag:
                key = (src, comm)
                q = atag.get(key)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, atag, key
            if aany:
                q = aany.get(comm)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, aany, comm
            if depth < 1:
                depth = 1
            if best is not None:
                q = best_bins[best_key]
                q.popleft()
                if not q:
                    del best_bins[best_key]
                nmatched += 1
                best.message = msg
                if expv is None:
                    expv = []
                expv += (depth, 1)
            else:
                # umq.add inlined: plain lazy append (the envelope
                # index catches up on the next specific receive)
                uq.append(msg)
                umq._lazy += 1
                ulen += 1
                if unexv is None:
                    unexv = []
                unexv += (depth, 1, ulen)
        if nmatched:
            prq._len -= nmatched
        if expv:
            buf += (pid, _ARR_EXP_COLS, expv, "cols")
        if unexv:
            buf += (pid, _ARR_UNEXP_COLS, unexv, "cols")
        self._seqn = sq
        self._tsample = tsample

    def run_ops(self, ops) -> None:
        """Run a mixed post/arrive stream on this engine: ``ops`` is a
        flat sequence of ``is_post, src, tag, nbytes, comm`` quints (the
        encoding :meth:`Fabric.exchange` accumulates for fused phases).
        Equivalent to the per-op calls in order — same matching, same
        counter multiset, same sampling cadence — with the dispatch cost
        paid once per engine per fused span."""
        reg = self._reg
        if (self.trace is not None or self.mode != "binned"
                or not reg.enabled):
            it = iter(ops)
            for is_post, src, tag, nb, comm in zip(it, it, it, it, it):
                if is_post:
                    self.post_recv(src, tag, comm)
                else:
                    self.arrive(src, tag, comm, nb)
            return
        if reg.epoch != self._epoch:
            self._buf = reg._buffer_for_current_thread()
            self._epoch = reg.epoch
        buf = self._buf
        pid = self._pid
        sq = self._seqn
        tsample = self._tsample
        umq = self.umq
        uq = umq._q
        uenv = umq._env
        prq = self.prq
        spec = prq._specific
        asrc = prq._any_src
        atag = prq._any_tag
        aany = prq._any_any
        new_recv = PostedRecv.__new__
        new_msg = Message.__new__
        hitv = missv = expv = unexv = None
        # consecutive ops usually share (tag, comm) — cache the last
        # resolved inner bin dicts (stable objects: emptied in place)
        utag = ucomm = stag = scomm = None
        uper = sper = None
        anys = ANY_SOURCE
        anyt = ANY_TAG
        tevery = TIMING_EVERY
        pcn = _pcn
        ulen = len(uq)                  # queue lengths mirrored in
        plen = prq._len                 # locals, written back once
        it = iter(ops)
        for is_post, src, tag, nb, comm in zip(it, it, it, it, it):
            sq += 1
            tsample -= 1
            if is_post:
                sns = -1
                if tsample:
                    if src != anys and tag != anyt:
                        if umq._lazy:
                            umq._flush_index()
                            utag = None  # flush may create env bins
                        if tag != utag or comm != ucomm:
                            utag = tag
                            ucomm = comm
                            uper = uenv.get((tag, comm))
                        per = uper
                        dq = per.get(src) if per else None
                        if dq:
                            msg = dq.popleft()
                            if not dq:
                                del per[src]
                            i = uq.index(msg)
                            if i < umq._cvalid:
                                umq.note_del(i)
                            del uq[i]
                            depth = i + 1
                        else:
                            msg, depth = None, ulen
                    else:
                        msg, depth = umq.match_env(src, tag, comm)
                else:
                    tsample = tevery
                    t0 = pcn()
                    msg, depth = umq.match_env(src, tag, comm)
                    sns = (pcn() - t0) * tevery
                    utag = None     # match_env may have flushed the
                    #                 lazy index, creating env bins
                if msg is not None:
                    if sns >= 0:
                        buf += (pid, "match.umq.length", ulen, True,
                                pid, "match.umq.traversal_depth", depth,
                                True,
                                pid, "match.umq.hit", 1, False,
                                pid, "match.umq.search_ns", sns, True)
                    else:
                        if hitv is None:
                            hitv = []
                        hitv += (ulen, depth, 1)
                    ulen -= 1         # recorded length was pre-match
                else:
                    recv = new_recv(PostedRecv)
                    recv.src = src
                    recv.tag = tag
                    recv.comm = comm
                    recv.seq = sq - 1
                    recv.message = None
                    if src != anys and tag != anyt:
                        if tag != stag or comm != scomm:
                            stag = tag
                            scomm = comm
                            sper = spec.get((tag, comm))
                        per = sper
                        if per is None:
                            per = sper = spec[(tag, comm)] = {}
                        bq = per.get(src)
                        if bq is None:
                            bq = per[src] = deque()
                        bq.append(recv)
                    else:
                        prq.post(recv)
                        prq._len -= 1   # the mirror owns the count
                        stag = None     # generic post may touch any bin
                    if sns >= 0:
                        buf += (pid, "match.umq.length", ulen, True,
                                pid, "match.umq.traversal_depth", depth,
                                True,
                                pid, "match.prq.length", plen, True,
                                pid, "match.umq.search_ns", sns, True)
                    else:
                        if missv is None:
                            missv = []
                        missv += (ulen, depth, plen)
                    plen += 1
                continue
            # arrival
            msg = new_msg(Message)
            msg.src = src
            msg.tag = tag
            msg.comm = comm
            msg.nbytes = nb
            msg.seq = sq - 1
            if not tsample:
                tsample = tevery
                t0 = pcn()
                recv, depth = prq.match(msg)
                sns = (pcn() - t0) * tevery
                if recv is not None:
                    prq._len += 1       # the mirror owns the count
                    plen -= 1
                    recv.message = msg
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.expected", 1, False)
                else:
                    umq.add(msg)        # lazy: creates no env bins
                    ulen += 1
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.unexpected", 1, False,
                            pid, "match.umq.length", ulen, True)
                continue
            depth = 0
            best = best_bins = best_key = None
            if spec:
                if tag != stag or comm != scomm:
                    stag = tag
                    scomm = comm
                    sper = spec.get((tag, comm))
                per = sper
                if per:
                    q = per.get(src)
                    if q:
                        depth = 1
                        best, best_bins, best_key = q[0], per, src
            if asrc:
                key = (tag, comm)
                q = asrc.get(key)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, asrc, key
            if atag:
                key = (src, comm)
                q = atag.get(key)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, atag, key
            if aany:
                q = aany.get(comm)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, aany, comm
            if depth < 1:
                depth = 1
            if best is not None:
                q = best_bins[best_key]
                q.popleft()
                if not q:
                    del best_bins[best_key]
                plen -= 1
                best.message = msg
                if expv is None:
                    expv = []
                expv += (depth, 1)
            else:
                uq.append(msg)
                umq._lazy += 1
                ulen += 1
                if unexv is None:
                    unexv = []
                unexv += (depth, 1, ulen)
        prq._len = plen
        if hitv:
            buf += (pid, _POST_HIT_COLS, hitv, "cols")
        if missv:
            buf += (pid, _POST_MISS_COLS, missv, "cols")
        if expv:
            buf += (pid, _ARR_EXP_COLS, expv, "cols")
        if unexv:
            buf += (pid, _ARR_UNEXP_COLS, unexv, "cols")
        self._seqn = sq
        self._tsample = tsample

    def post_recv_tags(self, src: int, tags, comm: int = 0) -> None:
        """Post one receive per tag in ``tags`` from a fixed ``src`` (the
        tag-scan shape: pipeline stages, backlog drains), equivalent to
        :meth:`post_recv` per tag — same fallbacks as
        :meth:`post_recv_batch`."""
        reg = self._reg
        if (self.trace is not None or self.mode != "binned"
                or not reg.enabled or src == ANY_SOURCE):
            for tag in tags:
                self.post_recv(src, tag, comm)
            return
        if reg.epoch != self._epoch:
            self._buf = reg._buffer_for_current_thread()
            self._epoch = reg.epoch
        buf = self._buf
        pid = self._pid
        sq = self._seqn
        tsample = self._tsample
        umq = self.umq
        uq = umq._q
        if umq._lazy:
            umq._flush_index()          # no arrivals run in this batch
        uenv = umq._env
        prq = self.prq
        spec = prq._specific
        new = PostedRecv.__new__
        hitv = missv = None
        ulen = len(uq)                  # queue lengths mirrored in
        plen = prq._len                 # locals, written back once
        for tag in tags:
            sq += 1
            tsample -= 1
            sns = -1
            if tsample:
                if tag != ANY_TAG:
                    per = uenv.get((tag, comm))
                    dq = per.get(src) if per else None
                    if dq:
                        msg = dq.popleft()
                        if not dq:
                            del per[src]
                        i = uq.index(msg)
                        if i < umq._cvalid:
                            umq.note_del(i)
                        del uq[i]
                        depth = i + 1
                    else:
                        msg, depth = None, ulen
                else:
                    msg, depth = umq.match_env(src, tag, comm)
            else:
                tsample = TIMING_EVERY
                t0 = _pcn()
                msg, depth = umq.match_env(src, tag, comm)
                sns = (_pcn() - t0) * TIMING_EVERY
            if msg is not None:
                if sns >= 0:
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.umq.hit", 1, False,
                            pid, "match.umq.search_ns", sns, True)
                else:
                    if hitv is None:
                        hitv = []
                    hitv += (ulen, depth, 1)
                ulen -= 1             # recorded length was pre-match
            else:
                recv = new(PostedRecv)
                recv.src = src
                recv.tag = tag
                recv.comm = comm
                recv.seq = sq - 1
                recv.message = None
                if tag != ANY_TAG:
                    per = spec.get((tag, comm))
                    if per is None:
                        per = spec[(tag, comm)] = {}
                    bq = per.get(src)
                    if bq is None:
                        bq = per[src] = deque()
                    bq.append(recv)
                else:
                    prq.post(recv)
                    prq._len -= 1       # the mirror owns the count
                if sns >= 0:
                    buf += (pid, "match.umq.length", ulen, True,
                            pid, "match.umq.traversal_depth", depth, True,
                            pid, "match.prq.length", plen, True,
                            pid, "match.umq.search_ns", sns, True)
                else:
                    if missv is None:
                        missv = []
                    missv += (ulen, depth, plen)
                plen += 1
        prq._len = plen
        if hitv:
            buf += (pid, _POST_HIT_COLS, hitv, "cols")
        if missv:
            buf += (pid, _POST_MISS_COLS, missv, "cols")
        self._seqn = sq
        self._tsample = tsample

    def arrive_tags(self, src: int, tags, comm: int = 0,
                    nbytes: int = 0) -> None:
        """Deliver one message per tag in ``tags`` from a fixed ``src``,
        equivalent to :meth:`arrive` per tag — same fallbacks as
        :meth:`arrive_batch`."""
        reg = self._reg
        if (self.trace is not None or self.mode != "binned"
                or not reg.enabled):
            for tag in tags:
                self.arrive(src, tag, comm, nbytes)
            return
        if reg.epoch != self._epoch:
            self._buf = reg._buffer_for_current_thread()
            self._epoch = reg.epoch
        buf = self._buf
        pid = self._pid
        sq = self._seqn
        tsample = self._tsample
        umq = self.umq
        uq = umq._q
        uenv = umq._env
        prq = self.prq
        spec = prq._specific
        asrc = prq._any_src
        atag_q = prq._any_tag.get((src, comm))   # fixed src: hoistable
        aany = prq._any_any
        new = Message.__new__
        expv = unexv = None
        ulen = len(uq)                  # mirrored for the batch
        nmatched = 0
        for tag in tags:
            msg = new(Message)
            msg.src = src
            msg.tag = tag
            msg.comm = comm
            msg.nbytes = nbytes
            msg.seq = sq
            sq += 1
            tsample -= 1
            if not tsample:
                tsample = TIMING_EVERY
                t0 = _pcn()
                recv, depth = prq.match(msg)
                sns = (_pcn() - t0) * TIMING_EVERY
                if recv is not None:
                    recv.message = msg
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.expected", 1, False)
                else:
                    umq.add(msg)
                    ulen += 1
                    buf += (pid, "match.prq.traversal_depth", depth, True,
                            pid, "match.prq.search_ns", sns, True,
                            pid, "match.unexpected", 1, False,
                            pid, "match.umq.length", ulen, True)
                continue
            depth = 0
            best = best_bins = best_key = None
            if spec:
                per = spec.get((tag, comm))
                if per:
                    q = per.get(src)
                    if q:
                        depth = 1
                        best, best_bins, best_key = q[0], per, src
            if asrc:
                key = (tag, comm)
                q = asrc.get(key)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, asrc, key
            if atag_q:
                depth += 1
                head = atag_q[0]
                if best is None or head.seq < best.seq:
                    best, best_bins, best_key = (
                        head, prq._any_tag, (src, comm))
            if aany:
                q = aany.get(comm)
                if q:
                    depth += 1
                    head = q[0]
                    if best is None or head.seq < best.seq:
                        best, best_bins, best_key = head, aany, comm
            if depth < 1:
                depth = 1
            if best is not None:
                q = best_bins[best_key]
                q.popleft()
                if not q:
                    del best_bins[best_key]
                nmatched += 1
                best.message = msg
                if expv is None:
                    expv = []
                expv += (depth, 1)
            else:
                uq.append(msg)
                umq._lazy += 1
                ulen += 1
                if unexv is None:
                    unexv = []
                unexv += (depth, 1, ulen)
        if nmatched:
            prq._len -= nmatched
        if expv:
            buf += (pid, _ARR_EXP_COLS, expv, "cols")
        if unexv:
            buf += (pid, _ARR_UNEXP_COLS, unexv, "cols")
        self._seqn = sq
        self._tsample = tsample

    # -- introspection -----------------------------------------------------

    def outstanding(self) -> Tuple[int, int]:
        """(posted receives pending, unexpected messages pending)."""
        return len(self.prq), len(self.umq)


class Fabric:
    """A set of ranks (one :class:`MatchEngine` each) plus the point-to-
    point decomposition of the collectives the comm layer dispatches.

    The interleave is deterministic: every ``unexpected_every``-th message
    arrives before its receive is posted (exercising the UMQ) and every
    ``wildcard_every``-th receive is posted with ``ANY_SOURCE``
    (exercising wildcard matching — and defect 2's leak path).

    Each rank's engine records into its own registry *lane*
    (``registry.lane(rank)``), so counter snapshots carry one pid per rank
    and render as separate timeline tracks; the registry's aggregate drain
    is unchanged. With ``trace`` set (a :class:`repro.trace.TraceWriter`
    or any ``emit(dict)`` sink), every collective dispatch writes a phase
    marker and every engine op writes a replayable record.
    """

    def __init__(self, mode: str = "binned",
                 registry: Optional[CounterRegistry] = None,
                 unexpected_every: int = 3, wildcard_every: int = 4,
                 trace=None, per_rank_lanes: bool = True):
        self.mode = canonical_mode(mode)
        self.reg = registry if registry is not None else global_registry()
        self.unexpected_every = unexpected_every
        self.wildcard_every = wildcard_every
        self.trace = trace
        self.per_rank_lanes = per_rank_lanes
        self._engines: Dict[int, MatchEngine] = {}
        self._tick = 0                  # messages dispatched so far
        self._label: Optional[str] = None
        self._depth = 0                 # collective/fused-span nesting
        self._fuse: Optional[Dict[int, List]] = None
        self._fusecm = _FusedSpan(self)
        # the unexpected/wildcard tick mix repeats with this period, so
        # `tick % period` captures everything an exchange plan's
        # lateness and wildcard substitution depend on (see _PLAN_CACHE)
        self._period = math.lcm(unexpected_every or 1,
                                wildcard_every or 1)
        # sanctioned fault-injection seam (repro.faults): a callable
        # (pairs, arrivals, tag, nbytes, comm) -> arrivals applied to
        # every exchange's arrival list *after* deliver validation — the
        # one place an arrival list may legally stop being a permutation
        # of the posts (drops, duplicates, deferred stragglers)
        self.arrival_filter = None

    def engine(self, rank: int) -> MatchEngine:
        eng = self._engines.get(rank)
        if eng is None:
            reg = self.reg.lane(rank) if self.per_rank_lanes else self.reg
            eng = self._engines[rank] = MatchEngine(
                rank=rank, mode=self.mode, registry=reg, trace=self.trace)
        return eng

    def engines(self) -> List[MatchEngine]:
        return [self._engines[r] for r in sorted(self._engines)]

    # -- trace phase markers ----------------------------------------------

    def set_label(self, label: Optional[str]) -> Optional[str]:
        """Set the label stamped on subsequent phase markers (the comm
        layer uses this to name phases after their dispatch site, e.g.
        ``psum(x)`` or ``ring_all_gather(r)``). Returns the previous
        label so callers can restore it."""
        prev = self._label
        self._label = label
        return prev

    def phase(self, label: str, **attrs) -> None:
        """Write an explicit phase marker into the trace (no-op when
        untraced). The replayer snapshots counters at every marker, which
        is what makes per-phase diffing possible."""
        if self.trace is not None:
            rec = {"t": "phase", "op": "phase", "label": label}
            rec.update(attrs)
            self.trace.emit(rec)

    def fused(self) -> "_FusedSpan":
        """Fused dispatch span: every collective or exchange inside the
        ``with`` block is accumulated per destination engine and run as
        one batched stream per engine at span exit (untraced only — a
        traced fabric keeps per-op dispatch so trace records interleave
        globally). Ops are deferred until exit, so do not read engine
        state (``engine()`` queues, ``outstanding()``, registry drains)
        inside the block. Scenario harnesses wrap tight multi-collective
        loops (e.g. the six face shifts of one halo step) in this."""
        if self.trace is None:
            return self._fusecm
        return _NULL_CONTEXT

    def _collective(self, op: str, **attrs):
        """Phase-mark one collective dispatch; nested decompositions
        (all_reduce -> reduce_scatter + all_gather) stay in the outer
        phase. Untraced there is nothing to mark — the fused span
        context batches the collective's whole op stream per engine
        instead."""
        if self.trace is None:
            return self._fusecm
        return self._collective_traced(op, attrs)

    @contextlib.contextmanager
    def _collective_traced(self, op: str, attrs):
        if self._depth == 0:
            rec = {"t": "phase", "op": op, "label": self._label or op}
            rec.update(attrs)
            self.trace.emit(rec)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    # -- one communication phase ------------------------------------------

    def exchange(self, pairs, tag: int = 0, nbytes: int = 0,
                 comm: int = 0, deliver=None) -> None:
        """Deliver one phase of point-to-point traffic: each (src, dst)
        pair is one message. Receives post first except for the
        deterministic 'unexpected' fraction, which post after delivery.
        ``deliver`` overrides the arrival order (default: post order) —
        the scenario suite uses it to drive adversarial-but-legal
        delivery orders (e.g. a transposed all-to-all).

        Untraced, the phase runs *batched*: messages are grouped by
        destination rank and dispatched through
        :meth:`MatchEngine.post_recv_batch` / :meth:`~MatchEngine
        .arrive_batch` — matching state is per-engine, every engine
        still sees its own ops in dispatch order, and the early-posts /
        arrivals / late-posts stage barriers are preserved, so outcomes
        and counter statistics are identical to the per-message path
        while the python dispatch cost is paid once per (stage, rank).
        With a trace attached the per-message path runs instead: trace
        records must interleave globally in dispatch order.

        ``deliver`` must be a permutation of ``pairs`` — a typo'd pair
        would fabricate an arrival with no matching post (or orphan a
        post silently), which is exactly the failure mode the fault-
        injection subsystem models *deliberately*; accidental versions
        of it raise ``ValueError`` here. Sanctioned non-permutation
        rewrites go through ``arrival_filter`` (see
        :mod:`repro.faults.inject`)."""
        if not isinstance(pairs, (list, tuple)):
            pairs = list(pairs)         # iterated once per stage
        if deliver is None:
            arr = pairs
        else:
            arr = (deliver if isinstance(deliver, (list, tuple))
                   else list(deliver))
            if Counter(arr) != Counter(pairs):
                raise ValueError(
                    "exchange(deliver=) is not a permutation of pairs: "
                    f"{len(arr)} arrivals vs {len(pairs)} posts; "
                    "injected drops/duplicates must go through "
                    "Fabric.arrival_filter (repro.faults), not deliver=")
        filt = self.arrival_filter
        if filt is not None:
            arr = filt(pairs, arr, tag, nbytes, comm)
        self._exchange(pairs, arr, tag, nbytes, comm)

    def _build_groups(self, pairs, arr, k: int):
        """Per-destination ``(early posts, arrivals, late posts)`` src
        groups for one phase starting at tick ``k`` — the grouping both
        untraced dispatch paths (and the plan cache) are defined over.
        With numpy present, phases of >= 64 pairs are grouped in one
        batched pass (tick arithmetic, wildcard substitution and the
        destination sort all vectorized); the pure-python loop is the
        numpy-absent fallback and produces identical groups. Groups are
        ordered by destination rank — engines are independent state
        machines, so cross-engine dispatch order is free."""
        ue = self.unexpected_every
        we = self.wildcard_every
        if _np is not None and len(pairs) >= 64:
            a = _np.array(pairs, dtype=_np.int64)
            srcs, dsts = a[:, 0], a[:, 1]
            t = _np.arange(k + 1, k + len(pairs) + 1, dtype=_np.int64)
            if we:
                srcs = _np.where(t % we == 0, ANY_SOURCE, srcs)
            if ue:
                late = t % ue == 0
                early = ~late
                post_g = _group_np(dsts[early], srcs[early])
                late_g = _group_np(dsts[late], srcs[late])
            else:
                post_g = _group_np(dsts, srcs)
                late_g = ()
            aa = a if arr is pairs else _np.array(arr, dtype=_np.int64)
            return post_g, _group_np(aa[:, 1], aa[:, 0]), late_g
        post_d: Dict[int, List[int]] = {}
        late_d: Dict[int, List[int]] = {}
        for src, dst in pairs:
            k += 1
            rsrc = ANY_SOURCE if we and k % we == 0 else src
            g = late_d if ue and k % ue == 0 else post_d
            grp = g.get(dst)
            if grp is None:
                grp = g[dst] = []
            grp.append(rsrc)
        arr_d: Dict[int, List[int]] = {}
        for src, dst in arr:
            grp = arr_d.get(dst)
            if grp is None:
                grp = arr_d[dst] = []
            grp.append(src)
        return (tuple(sorted(post_d.items())),
                tuple(sorted(arr_d.items())),
                tuple(sorted(late_d.items())))

    @staticmethod
    def _store_plan(key, plan):
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
        return plan

    def _fused_plan(self, key, pairs, arr, tag: int, nbytes: int,
                    comm: int, k: int):
        """Build + cache one phase's fused plan: per destination, the
        ready-to-extend flat quint segment (early posts, then arrivals,
        then late posts — the per-engine order the unfused path
        produces). The plan pins ``pairs``/``arr`` so the id-based
        cache key stays valid."""
        post_g, arr_g, late_g = self._build_groups(pairs, arr, k)
        segs: Dict[int, List] = {}
        for dst, srcs in post_g:
            seg = segs[dst] = []
            for s in srcs:
                seg += (True, s, tag, 0, comm)
        for dst, srcs in arr_g:
            seg = segs.get(dst)
            if seg is None:
                seg = segs[dst] = []
            for s in srcs:
                seg += (False, s, tag, nbytes, comm)
        for dst, srcs in late_g:
            seg = segs.get(dst)
            if seg is None:
                seg = segs[dst] = []
            for s in srcs:
                seg += (True, s, tag, 0, comm)
        return self._store_plan(key, (
            pairs, arr, tuple((d, tuple(s)) for d, s in segs.items())))

    def _exchange(self, pairs, arr, tag: int, nbytes: int,
                  comm: int) -> None:
        """Dispatch one validated/filtered phase: ``pairs`` drives the
        posts (and the unexpected/wildcard tick mix), ``arr`` drives the
        arrivals. Internal — :meth:`exchange` is the validated front
        door; :mod:`repro.faults` calls this directly after rewriting
        the two lists through its sanctioned seams."""
        k = self._tick
        ue = self.unexpected_every
        we = self.wildcard_every
        if (self._fuse is None and self.trace is None
                and len(pairs) < 64):
            # small direct phase: per-destination groups would be too
            # tiny to amortize a batch call each — run the whole phase
            # as one fused span (one run_ops per destination engine)
            with self._fusecm:
                self._exchange(pairs, arr, tag, nbytes, comm)
            return
        # plans are keyed by tuple identity: the memoized pattern
        # generators (repro_torch.comm.patterns) intern every recurring pair
        # list, so repeated phases hit; ad-hoc lists (fault-filtered
        # arrivals, hand-built pairs) fall through to the loop paths
        cacheable = (type(pairs) is tuple
                     and (arr is pairs or type(arr) is tuple))
        fuse = self._fuse
        if fuse is not None:
            # inside a fused span: accumulate flat (is_post, src, tag,
            # nbytes, comm) quints per destination; the span's exit runs
            # each engine's stream in one batch. Stage order per engine
            # (early posts, arrivals, late posts) is preserved.
            if cacheable:
                key = ("f", id(pairs), id(arr), ue, we,
                       k % self._period, tag, nbytes, comm)
                plan = _PLAN_CACHE.get(key)
                if plan is None:
                    plan = self._fused_plan(key, pairs, arr, tag,
                                            nbytes, comm, k)
                for dst, seg in plan[2]:
                    grp = fuse.get(dst)
                    if grp is None:
                        fuse[dst] = list(seg)
                    else:
                        grp += seg
                self._tick = k + len(pairs)
                return
            late_f: List[Tuple[int, int]] = []
            for src, dst in pairs:
                k += 1
                rsrc = ANY_SOURCE if we and k % we == 0 else src
                if ue and k % ue == 0:
                    late_f.append((rsrc, dst))
                else:
                    grp = fuse.get(dst)
                    if grp is None:
                        grp = fuse[dst] = []
                    grp += (True, rsrc, tag, 0, comm)
            self._tick = k
            for src, dst in arr:
                grp = fuse.get(dst)
                if grp is None:
                    grp = fuse[dst] = []
                grp += (False, src, tag, nbytes, comm)
            for rsrc, dst in late_f:
                grp = fuse.get(dst)
                if grp is None:
                    grp = fuse[dst] = []
                grp += (True, rsrc, tag, 0, comm)
            return
        if self.trace is None:
            if cacheable:
                key = ("d", id(pairs), id(arr), ue, we,
                       k % self._period)
                plan = _PLAN_CACHE.get(key)
                if plan is None:
                    plan = self._store_plan(key, (
                        pairs, arr, *self._build_groups(pairs, arr, k)))
                _, _, post_g, arr_g, late_g = plan
                self._tick = k + len(pairs)
                engine = self.engine
                for dst, srcs in post_g:
                    eng = engine(dst)
                    if len(srcs) > 1:
                        eng.post_recv_batch(srcs, tag, comm)
                    else:
                        eng.post_recv(srcs[0], tag, comm)
                for dst, srcs in arr_g:
                    eng = engine(dst)
                    if len(srcs) > 1:
                        eng.arrive_batch(srcs, tag, comm, nbytes)
                    else:
                        eng.arrive(srcs[0], tag, comm, nbytes)
                for dst, srcs in late_g:
                    eng = engine(dst)
                    if len(srcs) > 1:
                        eng.post_recv_batch(srcs, tag, comm)
                    else:
                        eng.post_recv(srcs[0], tag, comm)
                return
            post_g: Dict[int, List[int]] = {}
            late_g: Dict[int, List[int]] = {}
            for src, dst in pairs:
                k += 1
                rsrc = ANY_SOURCE if we and k % we == 0 else src
                g = late_g if ue and k % ue == 0 else post_g
                grp = g.get(dst)
                if grp is None:
                    grp = g[dst] = []
                grp.append(rsrc)
            self._tick = k
            for dst, srcs in post_g.items():
                eng = self.engine(dst)
                if len(srcs) > 1:
                    eng.post_recv_batch(srcs, tag, comm)
                else:
                    eng.post_recv(srcs[0], tag, comm)
            arr_g: Dict[int, List[int]] = {}
            for src, dst in arr:
                grp = arr_g.get(dst)
                if grp is None:
                    grp = arr_g[dst] = []
                grp.append(src)
            for dst, srcs in arr_g.items():
                eng = self.engine(dst)
                if len(srcs) > 1:
                    eng.arrive_batch(srcs, tag, comm, nbytes)
                else:
                    eng.arrive(srcs[0], tag, comm, nbytes)
            for dst, srcs in late_g.items():
                eng = self.engine(dst)
                if len(srcs) > 1:
                    eng.post_recv_batch(srcs, tag, comm)
                else:
                    eng.post_recv(srcs[0], tag, comm)
            return
        late: List[Tuple[int, int, int]] = []
        posts: Dict[int, object] = {}
        for src, dst in pairs:
            k += 1
            rsrc = ANY_SOURCE if we and k % we == 0 else src
            if ue and k % ue == 0:
                late.append((rsrc, dst, tag))
            else:
                post = posts.get(dst)
                if post is None:
                    post = posts[dst] = self.engine(dst).post_recv
                post(rsrc, tag, comm)
        self._tick = k
        arrives: Dict[int, object] = {}
        for src, dst in arr:
            arrive = arrives.get(dst)
            if arrive is None:
                arrive = arrives[dst] = self.engine(dst).arrive
            arrive(src, tag, comm, nbytes)
        for rsrc, dst, rtag in late:
            post = posts.get(dst)
            if post is None:
                post = posts[dst] = self.engine(dst).post_recv
            post(rsrc, rtag, comm)

    # -- collective decompositions (paper: ExaMPI's p2p collectives) -------

    @staticmethod
    def _ring(n: int, step: int = 1):
        return patterns.ring_perm(n, step)

    def ppermute(self, perm, nbytes: int = 0, tag: int = 0,
                 comm: int = 0) -> None:
        with self._collective("ppermute", tag=tag, nb=nbytes):
            self.exchange(perm, tag=tag, nbytes=nbytes, comm=comm)

    def all_gather(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("all_gather", n=n, nb=nbytes):
            for step in range(1, n):
                self.exchange(self._ring(n), tag=step,
                              nbytes=nbytes // max(n, 1), comm=comm)

    def reduce_scatter(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("reduce_scatter", n=n, nb=nbytes):
            for step in range(1, n):
                self.exchange(self._ring(n, -1), tag=step,
                              nbytes=nbytes // max(n, 1), comm=comm)

    def all_reduce(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        # ring all-reduce = reduce-scatter phase + all-gather phase
        with self._collective("all_reduce", n=n, nb=nbytes):
            self.reduce_scatter(n, nbytes=nbytes, comm=comm)
            self.all_gather(n, nbytes=nbytes, comm=comm)

    def all_to_all(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("all_to_all", n=n, nb=nbytes):
            self.exchange(patterns.transpose_pairs(n), tag=0,
                          nbytes=nbytes // max(n, 1), comm=comm)

    # -- introspection -----------------------------------------------------

    def outstanding(self) -> Tuple[int, int]:
        prq = sum(len(e.prq) for e in self._engines.values())
        umq = sum(len(e.umq) for e in self._engines.values())
        return prq, umq
