"""Frozen pre-overhaul matching engine — the hotpath bench's yardstick.

This is the hot path exactly as it stood before the indexed-UMQ /
batched-dispatch overhaul: per-op python dispatch, one
``observe``/``count`` registry call per counter record, two
``perf_counter_ns`` calls per op, and a linearly scanned, mid-list-
deleting unexpected-message queue (the old ``GCUMQ``). The semantics are
identical to the live engine — matching outcomes and deterministic
counter statistics agree op-for-op — only the cost differs, which is the
point: ``benchmarks/hotpath_bench.py`` drives every scenario through
both engines *interleaved in the same process* and gates on the
throughput ratio, so the speedup measurement is immune to machine-load
swings that would wreck a comparison against absolute numbers recorded
at some other time.

Do not "fix" or optimize this module; it is a measurement reference.
The batch entry points the scenario harnesses use (``post_recv_batch`` et
al.) are provided as plain per-op loops — exactly the dispatch the
pre-overhaul engine imposed on its callers.

A copy of ``repro.match.legacy``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..comm import patterns
from ..core.counters import CounterRegistry, global_registry
from .engine import (ANY_SOURCE, ANY_TAG, Message, PostedRecv,
                     canonical_mode)
from .defects import LeakyUMQ, LinearPRQ

_NULL_CONTEXT = contextlib.nullcontext()


class LegacyBinnedPRQ:
    """Pre-overhaul binned posted-receive queue (flat envelope keys,
    empty bins never reclaimed)."""

    def __init__(self) -> None:
        self._specific: Dict[Tuple[int, int, int], Deque[PostedRecv]] = {}
        self._any_src: Dict[Tuple[int, int], Deque[PostedRecv]] = {}
        self._any_tag: Dict[Tuple[int, int], Deque[PostedRecv]] = {}
        self._any_any: Dict[int, Deque[PostedRecv]] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def post(self, recv: PostedRecv) -> None:
        if recv.src == ANY_SOURCE and recv.tag == ANY_TAG:
            self._any_any.setdefault(recv.comm, deque()).append(recv)
        elif recv.src == ANY_SOURCE:
            self._any_src.setdefault((recv.tag, recv.comm),
                                     deque()).append(recv)
        elif recv.tag == ANY_TAG:
            self._any_tag.setdefault((recv.src, recv.comm),
                                     deque()).append(recv)
        else:
            self._specific.setdefault((recv.src, recv.tag, recv.comm),
                                      deque()).append(recv)
        self._len += 1

    def match(self, msg: Message) -> Tuple[Optional[PostedRecv], int]:
        depth = 0
        best: Optional[PostedRecv] = None
        best_q: Optional[Deque[PostedRecv]] = None
        queues = (
            self._specific.get((msg.src, msg.tag, msg.comm)),
            self._any_src.get((msg.tag, msg.comm)),
            self._any_tag.get((msg.src, msg.comm)),
            self._any_any.get(msg.comm),
        )
        for q in queues:
            if not q:
                continue
            depth += 1
            head = q[0]
            if best is None or head.seq < best.seq:
                best, best_q = head, q
        if best is not None and best_q is not None:
            best_q.popleft()
            self._len -= 1
        return best, max(depth, 1)


class GCUMQLinear:
    """Pre-overhaul unexpected-message queue: one arrival-ordered list,
    linear ``accepts`` scan, mid-list delete on every match."""

    def __init__(self) -> None:
        self._q: List[Message] = []

    def __len__(self) -> int:
        return len(self._q)

    def add(self, msg: Message) -> None:
        self._q.append(msg)

    def match(self, recv: PostedRecv) -> Tuple[Optional[Message], int]:
        for i, msg in enumerate(self._q):
            if recv.accepts(msg):
                del self._q[i]
                return msg, i + 1
        return None, len(self._q)


class LegacyMatchEngine:
    """Pre-overhaul engine: per-op dispatch, per-record counter calls,
    per-op wall-clock timing."""

    def __init__(self, rank: int = 0, mode: str = "binned",
                 registry: Optional[CounterRegistry] = None,
                 trace=None):
        mode = canonical_mode(mode)
        self.rank = rank
        self.mode = mode
        self.reg = registry if registry is not None else global_registry()
        self.trace = trace
        self.prq = LinearPRQ() if mode == "linear" else LegacyBinnedPRQ()
        self.umq = (LeakyUMQ(self.reg) if mode == "leaky_umq"
                    else GCUMQLinear())
        self._seq = itertools.count()

    def post_recv(self, src: int = ANY_SOURCE, tag: int = ANY_TAG,
                  comm: int = 0) -> PostedRecv:
        recv = PostedRecv(src=src, tag=tag, comm=comm, seq=next(self._seq))
        t0 = time.perf_counter_ns()
        self.reg.observe("match.umq.length", len(self.umq))
        msg, depth = self.umq.match(recv)
        self.reg.observe("match.umq.traversal_depth", depth)
        if msg is not None:
            recv.message = msg
            self.reg.count("match.umq.hit")
        else:
            self.reg.observe("match.prq.length", len(self.prq))
            self.prq.post(recv)
        self.reg.observe("match.umq.search_ns",
                         time.perf_counter_ns() - t0)
        if self.trace is not None:
            self.trace.emit({
                "t": "post", "rank": self.rank, "src": src, "tag": tag,
                "comm": comm, "seq": recv.seq,
                "hit": msg.seq if msg is not None else None})
        return recv

    def arrive(self, src: int, tag: int, comm: int = 0,
               nbytes: int = 0) -> Optional[PostedRecv]:
        msg = Message(src=src, tag=tag, comm=comm, nbytes=nbytes,
                      seq=next(self._seq))
        t0 = time.perf_counter_ns()
        recv, depth = self.prq.match(msg)
        self.reg.observe("match.prq.traversal_depth", depth)
        self.reg.observe("match.prq.search_ns",
                         time.perf_counter_ns() - t0)
        if recv is not None:
            recv.message = msg
            self.reg.count("match.expected")
        else:
            self.umq.add(msg)
            self.reg.count("match.unexpected")
            self.reg.observe("match.umq.length", len(self.umq))
        if self.trace is not None:
            self.trace.emit({
                "t": "arr", "rank": self.rank, "src": src, "tag": tag,
                "comm": comm, "nb": nbytes, "seq": msg.seq,
                "match": recv.seq if recv is not None else None})
        return recv

    # -- batch entry points (per-op loops: pre-overhaul dispatch) ---------

    def post_recv_batch(self, srcs, tag: int = ANY_TAG,
                        comm: int = 0) -> None:
        for src in srcs:
            self.post_recv(src, tag, comm)

    def arrive_batch(self, srcs, tag: int = 0, comm: int = 0,
                     nbytes: int = 0) -> None:
        for src in srcs:
            self.arrive(src, tag, comm, nbytes)

    def post_recv_tags(self, src: int, tags, comm: int = 0) -> None:
        for tag in tags:
            self.post_recv(src, tag, comm)

    def arrive_tags(self, src: int, tags, comm: int = 0,
                    nbytes: int = 0) -> None:
        for tag in tags:
            self.arrive(src, tag, comm, nbytes)

    def run_ops(self, ops) -> None:
        it = iter(ops)
        for is_post, src, tag, nb, comm in zip(it, it, it, it, it):
            if is_post:
                self.post_recv(src, tag, comm)
            else:
                self.arrive(src, tag, comm, nb)

    def outstanding(self) -> Tuple[int, int]:
        return len(self.prq), len(self.umq)


class LegacyFabric:
    """Pre-overhaul fabric: per-message dispatch in ``exchange``, no
    batching, no fusion (``fused()`` is a no-op context)."""

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
        self._engines: Dict[int, LegacyMatchEngine] = {}
        self._tick = itertools.count(1)
        self._label: Optional[str] = None
        self._depth = 0

    def engine(self, rank: int) -> LegacyMatchEngine:
        eng = self._engines.get(rank)
        if eng is None:
            reg = self.reg.lane(rank) if self.per_rank_lanes else self.reg
            eng = self._engines[rank] = LegacyMatchEngine(
                rank=rank, mode=self.mode, registry=reg, trace=self.trace)
        return eng

    def engines(self) -> List[LegacyMatchEngine]:
        return [self._engines[r] for r in sorted(self._engines)]

    def set_label(self, label: Optional[str]) -> Optional[str]:
        prev = self._label
        self._label = label
        return prev

    def fused(self):
        return _NULL_CONTEXT

    def phase(self, label: str, **attrs) -> None:
        if self.trace is not None:
            rec = {"t": "phase", "op": "phase", "label": label}
            rec.update(attrs)
            self.trace.emit(rec)

    @contextlib.contextmanager
    def _collective(self, op: str, **attrs):
        if self.trace is not None and self._depth == 0:
            rec = {"t": "phase", "op": op, "label": self._label or op}
            rec.update(attrs)
            self.trace.emit(rec)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def exchange(self, pairs, tag: int = 0, nbytes: int = 0,
                 comm: int = 0, deliver=None) -> None:
        late: List[Tuple[int, int, int]] = []
        for src, dst in pairs:
            k = next(self._tick)
            rsrc = (ANY_SOURCE
                    if self.wildcard_every and k % self.wildcard_every == 0
                    else src)
            if self.unexpected_every and k % self.unexpected_every == 0:
                late.append((rsrc, dst, tag))
            else:
                self.engine(dst).post_recv(rsrc, tag, comm)
        for src, dst in (pairs if deliver is None else deliver):
            self.engine(dst).arrive(src, tag, comm, nbytes)
        for rsrc, dst, rtag in late:
            self.engine(dst).post_recv(rsrc, rtag, comm)

    @staticmethod
    def _ring(n: int, step: int = 1):
        return patterns.ring_perm(n, step)

    def ppermute(self, perm, nbytes: int = 0, tag: int = 0,
                 comm: int = 0) -> None:
        with self._collective("ppermute", tag=tag, nb=nbytes):
            self.exchange(list(perm), tag=tag, nbytes=nbytes, comm=comm)

    def all_gather(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("all_gather", n=n, nb=nbytes):
            for step in range(1, n):
                self.exchange(self._ring(n), tag=step,
                              nbytes=nbytes // max(n, 1), comm=comm)

    def reduce_scatter(self, n: int, nbytes: int = 0,
                       comm: int = 0) -> None:
        with self._collective("reduce_scatter", n=n, nb=nbytes):
            for step in range(1, n):
                self.exchange(self._ring(n, -1), tag=step,
                              nbytes=nbytes // max(n, 1), comm=comm)

    def all_reduce(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("all_reduce", n=n, nb=nbytes):
            self.reduce_scatter(n, nbytes=nbytes, comm=comm)
            self.all_gather(n, nbytes=nbytes, comm=comm)

    def all_to_all(self, n: int, nbytes: int = 0, comm: int = 0) -> None:
        with self._collective("all_to_all", n=n, nb=nbytes):
            self.exchange(patterns.transpose_pairs(n), tag=0,
                          nbytes=nbytes // max(n, 1), comm=comm)

    def outstanding(self) -> Tuple[int, int]:
        prq = sum(len(e.prq) for e in self._engines.values())
        umq = sum(len(e.umq) for e in self._engines.values())
        return prq, umq
