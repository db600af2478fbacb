"""Strong-progress engine — a faithful host-level port of ExaMPI's §4
architecture, including the defect and the fix.

ExaMPI devotes a per-process *progress thread* to completing communication
requests that the *user thread* enqueues (strong progress, paper §2.1).
Before the fix, both threads shared ONE request queue guarded by one
mutex, and the progress thread held that mutex *while processing*; the
user thread's MPI_Isend therefore blocked for the whole processing
quantum (Fig. 8), and Isend latency grew with the number of pending
requests (Fig. 10). The fix added a second *incoming* queue the producer
can always append to; the progress thread swaps it into a private
internal queue and processes without holding the shared lock (Fig. 9).

  ProgressEngine(mode="shared")    the pre-fix design (one queue)
  ProgressEngine(mode="incoming")  the post-fix design (second queue)

``submit`` is the MPI_Isend analog (returns a Request); Request.wait is
MPI_Wait. Both threads annotate their critical sections with the region
name "BlockingProgress lock", so timeline contention analysis
(core.analyses.contention) finds the defect exactly as the paper's
Fig. 8 does.

Port of ``repro.comm.progress``. On a CUDA card the progress thread issues
on a stream of its own: PyTorch's current stream is per thread, and on the
caller's stream the exchange would queue behind the caller's work (the
interior stencil) and nothing would overlap. Work submitted from a CUDA
stream first waits for what that stream had queued (an event recorded at
submit), and :meth:`Request.wait` makes the caller's stream wait for an
event recorded on the engine's stream after the work.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Optional, Tuple

import torch

from ..core import regions
from ..device import tensors

LOCK_REGION = "BlockingProgress lock"


class Request:
    __slots__ = ("_event", "_result", "_exc", "label", "engine_stream",
                 "issued", "done_on")

    def __init__(self, label: Optional[str] = None):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.label = label
        # on a card: the engine's stream, and events recorded on the
        # submitter's stream at submit and on the engine's after the work
        self.engine_stream: Optional[torch.cuda.Stream] = None
        self.issued: Optional[torch.cuda.Event] = None
        self.done_on: Optional[torch.cuda.Event] = None

    def _fulfill(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        with regions.annotate("MPI_Wait", category="api"):
            if not self._event.wait(timeout):
                what = (f"request {self.label!r}" if self.label
                        else "request")
                raise TimeoutError(
                    f"{what} not completed after {timeout}s (progress "
                    "engine stalled or shut down with work pending?)")
            if self._exc is not None:
                raise self._exc
            if self.done_on is not None:
                # the caller's stream runs on only after the engine's work;
                # the result's memory stays reserved until the caller's
                # stream has used it
                stream = torch.cuda.current_stream(self.engine_stream.device)
                stream.wait_event(self.done_on)
                for t in tensors(self._result):
                    if t.is_cuda:
                        t.record_stream(stream)
            return self._result


class ProgressEngine:
    """``trace`` is an optional ``emit(dict)`` sink (:mod:`repro.trace`):
    every submit records its enqueue timestamp and lock wait, every
    processed request its processing quantum, so the offline replayer can
    re-model the same request stream under the *other* queue discipline
    (the shared-queue defect vs the incoming-queue fix) without rerunning
    any communication.

    ``process_fn`` overrides the completion step run on each request's
    result (the default waits until the card has finished the request's
    work, as the reference's ``jax.block_until_ready``) — pass a plain
    callable to drive the engine device-free, e.g. a spin quantum in the
    fault-scenario harness.

    ``stream`` is the CUDA stream the progress thread issues on: made on
    the current card when the engine starts, None without a card.

    Lifecycle: the progress thread starts in the constructor
    (``autostart=False`` defers it); :meth:`start` and :meth:`shutdown`
    are both idempotent, and :meth:`start` after :meth:`shutdown`
    brings the engine back up. Submitting to a stopped engine raises
    instead of queueing work nothing will ever complete."""

    def __init__(self, mode: str = "incoming", process_fn=None,
                 trace=None, autostart: bool = True):
        assert mode in ("shared", "incoming")
        self.mode = mode
        self.process_fn = process_fn
        self.trace = trace
        self._lock = threading.Lock()            # the BlockingProgress lock
        self._queue: Deque[Tuple[Callable, tuple, Request]] = deque()
        self._internal: Deque[Tuple[Callable, tuple, Request]] = deque()
        self._wake = threading.Event()
        self._stop = False
        self._state = threading.Lock()           # start/shutdown guard
        self._thread: Optional[threading.Thread] = None
        self.stream: Optional[torch.cuda.Stream] = None
        if autostart:
            self.start()

    # ---- user-thread side ---------------------------------------------------

    def start(self) -> None:
        """Start (or restart) the progress thread; a no-op when it is
        already running."""
        with self._state:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._wake.clear()
            if self.stream is None and torch.cuda.is_available():
                self.stream = torch.cuda.Stream()
            self._thread = threading.Thread(
                target=self._progress_loop, name="progress", daemon=True)
            self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, fn: Callable, *args: Any,
               label: Optional[str] = None) -> Request:
        """MPI_Isend analog: enqueue a communication request. ``label``
        names the request in ``Request.wait(timeout=...)`` errors."""
        if self._stop or self._thread is None:
            raise RuntimeError(
                "progress engine is not running (submit after "
                "shutdown, or before start with autostart=False)")
        req = Request(label=label)
        if self.stream is not None:
            req.engine_stream = self.stream
            req.issued = torch.cuda.Event()
            req.issued.record(torch.cuda.current_stream(self.stream.device))
        t0 = time.perf_counter_ns()
        with regions.annotate("MPI_Isend", category="api", mode=self.mode):
            with regions.annotate(LOCK_REGION, category="runtime",
                                  lock="request_queue"):
                with self._lock:
                    self._queue.append((fn, args, req))
            self._wake.set()
        if self.trace is not None:
            try:
                self.trace.emit({"t": "pe", "ev": "submit", "ts": t0,
                                 "wait": time.perf_counter_ns() - t0})
            except Exception:
                pass         # tracing is best-effort; the request is queued
        return req

    def shutdown(self):
        """Stop the progress thread (idempotent; safe to call twice or
        on a never-started engine)."""
        with self._state:
            thread = self._thread
            if thread is None:
                return
            self._stop = True
            self._wake.set()
            thread.join(timeout=10)

    # ---- progress-thread side -------------------------------------------------

    def _progress_loop(self):
        if self.stream is None:
            return self._loop()
        with torch.cuda.stream(self.stream):
            return self._loop()

    def _loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            if self.mode == "shared":
                # DEFECT: hold the shared lock while *processing* — the
                # user thread's Isend blocks for the whole quantum.
                with regions.annotate(LOCK_REGION, category="runtime",
                                      lock="request_queue"):
                    with self._lock:
                        while self._queue:
                            fn, args, req = self._queue.popleft()
                            self._process(fn, args, req)
            else:
                # FIX: grab the incoming queue quickly, process privately.
                with regions.annotate(LOCK_REGION, category="runtime",
                                      lock="request_queue"):
                    with self._lock:
                        while self._queue:
                            self._internal.append(self._queue.popleft())
                while self._internal:
                    fn, args, req = self._internal.popleft()
                    self._process(fn, args, req)

    def _process(self, fn, args, req: Request):
        t0 = time.perf_counter_ns()
        with regions.annotate("progress/process", category="runtime"):
            try:
                if self.stream is not None:
                    self.stream.wait_event(req.issued)
                    for t in tensors(args):
                        if t.is_cuda:
                            t.record_stream(self.stream)
                result = fn(*args)
                if self.stream is not None:
                    req.done_on = torch.cuda.Event()
                    req.done_on.record(self.stream)
                if self.process_fn is not None:
                    self.process_fn(result)
                elif req.done_on is not None:
                    req.done_on.synchronize()
                req._fulfill(result)
            except BaseException as e:           # surfaced at wait()
                req._fulfill(exc=e)
        if self.trace is not None:
            try:
                self.trace.emit({"t": "pe", "ev": "proc", "ts": t0,
                                 "dur": time.perf_counter_ns() - t0})
            except Exception:
                pass         # never take down the progress thread (a dead
                             # progress thread deadlocks every later wait)
