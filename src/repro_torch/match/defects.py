"""Seeded matching-engine defects (paper methodology: plant a known
implementation defect, then show the counter subsystem finds it).

Both defects are real-world failure classes the paper's second profiling
method targets:

  * :class:`LinearPRQ` — the posted-receive queue is one flat list with
    no envelope binning; every arrival scans linearly from the head.
    Matching cost grows with the number of outstanding receives, which
    the ``match.prq.traversal_depth`` histogram exposes directly (the
    ``long_traversal`` detector in :mod:`repro_torch.core.analyses`).

  * :class:`LeakyUMQ` — unexpected messages consumed via *wildcard*
    receives are tombstoned instead of removed, so the queue never
    shrinks; every later traversal pays for the garbage. The
    ``match.umq.length`` histogram grows without bound (the
    ``umq_flood`` detector).

Selected through ``MatchEngine(mode="linear")`` / ``mode="leaky_umq"``;
``mode="binned"`` is the fixed design.

A copy of ``repro.match.defects``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.counters import CounterRegistry
from . import engine as _engine


class LinearPRQ:
    """Defect 1: flat posted-receive queue, linear search, no binning.

    ``_len`` mirrors the queue length as a plain attribute (the engine's
    instrumentation reads it without a ``__len__`` dispatch) — pure
    bookkeeping, the pathological linear scan below is the defect and
    stays untouched."""

    def __init__(self) -> None:
        self._q: List["_engine.PostedRecv"] = []
        self._len = 0

    def __len__(self) -> int:
        return len(self._q)

    def post(self, recv: "_engine.PostedRecv") -> None:
        self._q.append(recv)
        self._len += 1

    def match(self, msg: "_engine.Message"
              ) -> Tuple[Optional["_engine.PostedRecv"], int]:
        # front-to-back scan keeps MPI post order, at linear cost
        for i, recv in enumerate(self._q):
            if recv.accepts(msg):
                del self._q[i]
                self._len -= 1
                return recv, i + 1
        return None, max(len(self._q), 1)


class LeakyUMQ:
    """Defect 2: unexpected-message queue never garbage-collected on
    wildcard matches — consumed entries stay as tombstones."""

    def __init__(self, registry: CounterRegistry) -> None:
        self._q: List["_engine.Message"] = []
        self._reg = registry

    def __len__(self) -> int:
        return len(self._q)        # tombstones included: the leak is visible

    def add(self, msg: "_engine.Message") -> None:
        self._q.append(msg)

    def match(self, recv: "_engine.PostedRecv"
              ) -> Tuple[Optional["_engine.Message"], int]:
        for i, msg in enumerate(self._q):
            if msg.matched:
                continue           # traversals still pay for the garbage
            if recv.accepts(msg):
                if recv.wildcard:
                    msg.matched = True          # the leak
                    self._reg.count("match.umq.leaked")
                else:
                    del self._q[i]
                return msg, i + 1
        return None, max(len(self._q), 1)
