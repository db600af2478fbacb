"""Event collector.

Design note (and a deliberate nod to the paper): the collector itself uses
the *second-queue* pattern from §4 of the paper. Producer threads append
to **thread-local** buffers (no shared lock on the hot path — CPython list
appends are atomic); the reader drains those buffers into its own private
list before processing. Producers therefore never contend with the
consumer, exactly like ExaMPI's user thread never waiting on the progress
thread after the incoming-queue fix.

A copy of ``repro.core.collector``: the port imports nothing of the JAX package.
Keep the two in step.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

from .events import Event


class Collector:
    """Thread-safe, low-overhead event sink."""

    def __init__(self, pid: int = 0):
        self.pid = pid
        self._registry_lock = threading.Lock()   # cold path only
        self._buffers: Dict[int, List[Event]] = {}
        self._tid_map: Dict[int, int] = {}       # OS thread ident -> small int
        self._drained: List[Event] = []
        self.enabled = True

    # -- producer side (hot path, lock-free after first call per thread) --

    def _buffer_for_current_thread(self) -> List[Event]:
        ident = threading.get_ident()
        buf = self._buffers.get(ident)
        if buf is None:
            with self._registry_lock:
                buf = self._buffers.setdefault(ident, [])
                self._tid_map.setdefault(ident, len(self._tid_map))
        return buf

    def normalized_tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tid_map.get(ident)
        if tid is None:
            self._buffer_for_current_thread()
            tid = self._tid_map[threading.get_ident()]
        return tid

    def emit(self, event: Event) -> None:
        if self.enabled:
            self._buffer_for_current_thread().append(event)

    # -- consumer side --

    def drain(self) -> List[Event]:
        """Move all buffered events into the drained list and return a copy
        of everything collected so far (sorted by start time)."""
        with self._registry_lock:
            idents = list(self._buffers.keys())
        for ident in idents:
            buf = self._buffers[ident]
            # atomically snapshot-and-clear: swap out the consumed prefix
            n = len(buf)
            self._drained.extend(buf[:n])
            del buf[:n]
        self._drained.sort(key=lambda e: (e.t_start, e.t_end))
        return list(self._drained)

    def clear(self) -> None:
        with self._registry_lock:
            for buf in self._buffers.values():
                del buf[:]
            self._drained.clear()

    def extend(self, events: Iterable[Event]) -> None:
        """Inject externally produced events (e.g. parsed from another rank)."""
        self._drained.extend(events)


_GLOBAL: Optional[Collector] = None
_GLOBAL_LOCK = threading.Lock()


def global_collector() -> Collector:
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Collector()
    return _GLOBAL


def reset_global_collector(pid: int = 0) -> Collector:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = Collector(pid=pid)
    return _GLOBAL
