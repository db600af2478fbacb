"""Frame subscribers: where the bridge pushes telemetry frames.

A subscriber is anything with ``push(frame: dict)``; ``close()`` is
optional. Pushes happen on the bridge's poll thread, so subscribers must
be cheap and must never block — the backpressure policy throughout is
*drop oldest and count*: a slow consumer loses history, never stalls the
poller (the same producer-never-waits stance as the counter hot path).

A copy of ``repro.telemetry.subscribers``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from .schema import dumps


class FrameRing:
    """Bounded in-process frame buffer (tests, TUIs, the SSE replay).

    Thread-safe; at most ``capacity`` frames are retained and older ones
    are dropped (``dropped`` counts them). ``frames()`` returns a stable
    snapshot copy."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=capacity)
        self.pushed = 0
        self.dropped = 0

    def push(self, frame: Dict) -> None:
        with self._lock:
            if len(self._frames) == self.capacity:
                self.dropped += 1
            self._frames.append(frame)
            self.pushed += 1

    def frames(self) -> List[Dict]:
        with self._lock:
            return list(self._frames)

    def latest(self, kind: Optional[str] = None) -> Optional[Dict]:
        with self._lock:
            for frame in reversed(self._frames):
                if kind is None or frame.get("t") == kind:
                    return frame
        return None

    def clear(self) -> None:
        with self._lock:
            self._frames.clear()

    def close(self) -> None:  # part of the subscriber contract
        pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)


class JsonlSink:
    """Append frames to a JSONL file, one compact object per line.

    Buffered writes with a periodic flush (every ``flush_every`` frames)
    keep the poll thread off the disk most polls; ``close()`` flushes."""

    def __init__(self, path: str, flush_every: int = 16):
        self.path = str(path)
        self.flush_every = max(1, flush_every)
        self._lock = threading.Lock()
        self._f = open(self.path, "w", encoding="utf-8")
        self.pushed = 0

    def push(self, frame: Dict) -> None:
        line = dumps(frame)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self.pushed += 1
            if self.pushed % self.flush_every == 0:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_jsonl(path: str) -> List[Dict]:
    """Load a JSONL sink file back into frames (post-hoc analysis of a
    live session — the stream is its own trace)."""
    out: List[Dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class CallbackSubscriber:
    """Adapt a bare callable to the subscriber contract."""

    def __init__(self, fn: Callable[[Dict], None]):
        self._fn = fn

    def push(self, frame: Dict) -> None:
        self._fn(frame)

    def close(self) -> None:
        pass


class ClientQueue:
    """Per-consumer bounded handoff between the poll thread and a slow
    reader (each SSE client gets one). ``push`` never blocks: when the
    queue is full the oldest frame is dropped and counted. ``pop`` blocks
    the *consumer* (with timeout) — never the producer."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = capacity
        self._cond = threading.Condition()
        self._frames: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.closed = False

    def push(self, frame: Dict) -> None:
        with self._cond:
            if self.closed:
                return
            if len(self._frames) == self.capacity:
                self.dropped += 1
            self._frames.append(frame)
            self._cond.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[Dict]:
        """Next frame, or None on timeout / after close drains dry."""
        with self._cond:
            if not self._frames:
                self._cond.wait(timeout)
            if self._frames:
                return self._frames.popleft()
            return None

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
