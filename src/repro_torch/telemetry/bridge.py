"""TelemetryBridge: live delta streaming over the columnar counter drain.

The bridge turns the repo's pull-based profiling substrate into a
continuous feed (the paper's "profile as a practice, not a post-mortem"
stance). It polls watched :class:`CounterRegistry` instances on its own
daemon thread at a configurable period; each poll takes one
:meth:`snapshot` through the existing swap-out columnar path — producers
never block, the bridge is just another consumer serialized on the
registry's drain lock — and the per-pid lane *delta* since the previous
poll is pushed to subscribers as a compact schema-versioned frame. The
bridge folds every delta into a cumulative per-source view, so at any
instant it can answer "what do the counters say so far" (``/metrics``)
and run the cheap incremental detectors (``umq_flood`` /
``long_traversal`` on cumulative lanes, ``contention`` on a rolling
window of region events) so defects surface *while the workload runs*.

No-loss accounting: every frame carries the registry's drain-epoch
metadata (``deltas_merged`` / ``pending``), and the bridge's own
``deltas_total`` is the sum of logical deltas it adopted — with the
bridge as sole consumer the two agree exactly, and with a concurrent
consumer (a run draining its own registry mid-poll) the split is visible
instead of silent.

A copy of ``repro.telemetry.bridge``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Union

from ..core.analyses import (Finding, contention, duplicate_match_lanes,
                             long_traversal_lanes, orphan_posts_lanes,
                             recovered_drop_lanes, reorder_inflation_lanes,
                             retry_storm_lanes, straggler_rank_lanes,
                             suppressed_duplicate_lanes, umq_flood_lanes)
from ..core.collector import Collector
from ..core.counters import (COUNTER_CATEGORY, CounterRegistry,
                             merge_lane_stats)
from .schema import (Lanes, make_delta_frame, make_end_frame,
                     make_finding_frame, make_telemetry_header, now_ms)
from .subscribers import CallbackSubscriber, FrameRing

DEFAULT_PERIOD_S = 0.025


class TelemetryBridge:
    """Polls counter registries, streams delta frames, runs detectors.

    Usage::

        bridge = TelemetryBridge(period_s=0.025)
        bridge.watch(registry, name="storm")
        bridge.subscribe(JsonlSink("run.telemetry.jsonl"))
        with bridge:                      # start() ... stop()
            run_workload()
        lanes = bridge.cumulative["storm"]   # full-run per-pid stats

    Or, for exact end-of-run accounting while the bridge keeps serving
    other sources: ``lanes = bridge.unwatch(registry)`` (final poll, then
    the source's cumulative lanes are handed to the caller).
    """

    def __init__(self, period_s: float = DEFAULT_PERIOD_S,
                 session: str = "repro",
                 detectors: bool = True,
                 ring_capacity: int = 512,
                 umq_max_length: float = 64.0,
                 umq_mean_length: float = 8.0,
                 prq_mean_depth: float = 8.0,
                 prq_min_samples: int = 32,
                 contention_window_s: float = 0.25,
                 adaptive: bool = False,
                 min_period_s: Optional[float] = None,
                 max_period_s: Optional[float] = None,
                 backoff: float = 1.5):
        if period_s <= 0:
            raise ValueError("poll period must be positive")
        self.period_s = period_s
        # Adaptive pacing (opt-in; default off so the fixed-period
        # overhead-gate semantics are untouched): each zero-delta poll
        # backs the period off by `backoff` toward max_period_s — an
        # idle workload costs ever fewer snapshots — and each poll that
        # adopts deltas tightens it by the same factor toward
        # min_period_s, so a dense frame stream is sampled finely.
        self.adaptive = adaptive
        self.backoff = backoff
        self.min_period_s = (min_period_s if min_period_s is not None
                             else period_s / 4.0)
        self.max_period_s = (max_period_s if max_period_s is not None
                             else period_s * 16.0)
        if adaptive:
            if backoff <= 1.0:
                raise ValueError("adaptive backoff must be > 1")
            if not 0 < self.min_period_s <= self.max_period_s:
                raise ValueError("need 0 < min_period_s <= max_period_s")
        self.current_period_s = min(max(period_s, self.min_period_s),
                                    self.max_period_s) \
            if adaptive else period_s
        self.session = session
        self.detectors = detectors
        self.umq_max_length = umq_max_length
        self.umq_mean_length = umq_mean_length
        self.prq_mean_depth = prq_mean_depth
        self.prq_min_samples = prq_min_samples
        self.contention_window_s = contention_window_s

        self.ring = FrameRing(ring_capacity)
        self._subs: List = [self.ring]
        # One reentrant-free lock guards sources, cumulative views,
        # findings and the poll itself; the poll thread and explicit
        # poll()/unwatch() callers serialize here. Registry producers
        # never touch this lock (they are lock-free by design).
        self._lock = threading.Lock()
        self._registries: Dict[str, CounterRegistry] = {}
        self._collectors: Dict[str, Collector] = {}
        self.cumulative: Dict[str, Lanes] = {}
        self.findings: List[Dict] = []       # JSON-ready, src included
        self._finding_keys: set = set()
        self._names = itertools.count()

        self.polls = 0
        self.deltas_total = 0
        self.frames_pushed = 0
        self.push_errors = 0
        self.poll_errors = 0
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._header_sent = False

    # -- source management -------------------------------------------------

    def watch(self, registry: CounterRegistry,
              name: Optional[str] = None) -> str:
        """Start polling ``registry``; returns the source name frames are
        tagged with."""
        with self._lock:
            name = self._claim_name(name)
            self._registries[name] = registry
            self.cumulative.setdefault(name, {})
        return name

    def watch_events(self, collector: Collector,
                     name: Optional[str] = None) -> str:
        """Watch a region-event :class:`Collector` for the rolling-window
        ``contention`` detector (reads are non-destructive — the run's
        end-of-run GraphFrame still sees every event)."""
        with self._lock:
            name = self._claim_name(name)
            self._collectors[name] = collector
        return name

    def _claim_name(self, name: Optional[str]) -> str:
        if name is None:
            name = f"src{next(self._names)}"
        if name in self._registries or name in self._collectors:
            raise ValueError(f"telemetry source {name!r} already watched")
        return name

    def unwatch(self, source: Union[str, CounterRegistry, Collector],
                final_poll: bool = True) -> Optional[Lanes]:
        """Stop watching a source. For a registry source, a final poll
        runs first (unless disabled) and the source's cumulative per-pid
        lanes are returned — ownership transfers to the caller, so a
        bench can feed them straight to :func:`lane_events` for results
        identical to an unbridged run."""
        with self._lock:
            name = self._resolve(source)
            if name is None:
                raise KeyError(f"unknown telemetry source {source!r}")
            if name in self._collectors:
                del self._collectors[name]
                return None
            if final_poll:
                self._poll_locked(only=name)
            del self._registries[name]
            return self.cumulative.pop(name)

    def _resolve(self, source) -> Optional[str]:
        if isinstance(source, str):
            if source in self._registries or source in self._collectors:
                return source
            return None
        for name, reg in self._registries.items():
            if reg is source:
                return name
        for name, col in self._collectors.items():
            if col is source:
                return name
        return None

    # -- subscribers -------------------------------------------------------

    def subscribe(self, sub) -> object:
        """Register a subscriber (``push(frame)`` object or bare
        callable); returns the handle to pass to :meth:`unsubscribe`."""
        if callable(sub) and not hasattr(sub, "push"):
            sub = CallbackSubscriber(sub)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def _push(self, frame: Dict) -> None:
        # Called with the lock held. A failing subscriber must not take
        # the poll thread down (or stall other subscribers): count and
        # carry on — same drop-don't-block stance as ClientQueue.
        for sub in self._subs:
            try:
                sub.push(frame)
            except Exception:
                self.push_errors += 1
        self.frames_pushed += 1

    # -- polling -----------------------------------------------------------

    def poll(self) -> int:
        """One synchronous poll of every watched source (the background
        thread calls this; tests and unthreaded callers may too).
        Returns the number of logical deltas adopted by this poll — the
        signal the adaptive pacer steers on."""
        with self._lock:
            return self._poll_locked()

    def _poll_locked(self, only: Optional[str] = None) -> int:
        nd_poll = 0
        if not self._header_sent:
            self._send_header_locked()
        ts = now_ms()
        for name, reg in list(self._registries.items()):
            if only is not None and name != only:
                continue
            snap = reg.snapshot()
            lanes: Lanes = snap["lanes"]
            meta = dict(snap["meta"])
            if lanes:
                # encode (copies values) *before* the cumulative merge
                # adopts the stat objects — frames must never alias
                # stats that later polls keep mutating.
                self._seq += 1
                frame = make_delta_frame(self._seq, name, lanes,
                                         meta=meta, ts=ts)
                nd = merge_lane_stats(self.cumulative[name], lanes)
                frame["m"]["nd"] = nd
                self.deltas_total += nd
                nd_poll += nd
                self._push(frame)
            if self.detectors:
                self._detect_lanes_locked(name, ts)
        if only is None:
            if self.detectors:
                for name, col in list(self._collectors.items()):
                    self._detect_contention_locked(name, col, ts)
            self.polls += 1
        return nd_poll

    def _send_header_locked(self) -> None:
        names = list(self._registries) + list(self._collectors)
        self._push(make_telemetry_header(self.session, self.period_s, names))
        self._header_sent = True

    # -- detectors ---------------------------------------------------------

    def _detect_lanes_locked(self, name: str, ts: int) -> None:
        cum = self.cumulative[name]
        found = umq_flood_lanes(cum, max_length=self.umq_max_length,
                                mean_length=self.umq_mean_length)
        found += long_traversal_lanes(cum, mean_depth=self.prq_mean_depth,
                                      min_samples=self.prq_min_samples)
        # fault-class detectors: mid-run the orphan/residue algebra sees
        # in-flight posts/parks, so these fire as *leading indicators*
        # (first firing wins); the post-hoc sweep gate re-judges them at
        # end-of-run where the algebra is exact
        found += orphan_posts_lanes(cum)
        found += duplicate_match_lanes(cum)
        found += reorder_inflation_lanes(cum)
        found += straggler_rank_lanes(cum)
        found += recovered_drop_lanes(cum)
        found += suppressed_duplicate_lanes(cum)
        found += retry_storm_lanes(cum)
        self._record_findings_locked(name, found, ts)

    def _detect_contention_locked(self, name: str, col: Collector,
                                  ts: int) -> None:
        events = col.drain()          # cumulative, non-destructive
        if not events:
            return
        hi = max(e.t_end for e in events)
        lo = hi - int(self.contention_window_s * 1e9)
        window = [e for e in events
                  if e.t_end >= lo and e.category != COUNTER_CATEGORY]
        self._record_findings_locked(name, contention(window), ts)

    def _record_findings_locked(self, source: str,
                                found: List[Finding], ts: int) -> None:
        for f in found:
            # First firing wins: a flood keeps flooding every poll, but
            # the live feed should say it once (per source/kind/rank).
            key = (source, f.kind, f.pid)
            if key in self._finding_keys:
                continue
            self._finding_keys.add(key)
            self._seq += 1
            payload = f.to_dict()
            frame = make_finding_frame(self._seq, source, payload, ts=ts)
            payload["src"] = source
            payload["ts"] = ts
            self.findings.append(payload)
            self._push(frame)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TelemetryBridge":
        if self._thread is not None:
            raise RuntimeError("telemetry bridge already started")
        self._stop.clear()
        with self._lock:
            if not self._header_sent:
                self._send_header_locked()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-bridge")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.current_period_s):
            try:
                nd = self.poll()
            except Exception:
                self.poll_errors += 1
                continue
            if self.adaptive:
                self._adapt(nd)

    def _adapt(self, nd: int) -> None:
        p = self.current_period_s
        p = p / self.backoff if nd else p * self.backoff
        self.current_period_s = min(max(p, self.min_period_s),
                                    self.max_period_s)

    def stop(self) -> None:
        """Stop the poll thread, run one final poll (nothing buffered at
        the instant of stop is lost), emit the end frame."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        with self._lock:
            self._poll_locked()
            self._seq += 1
            self._push(make_end_frame(self._seq, self.polls,
                                      self.deltas_total,
                                      len(self.findings)))

    def close(self) -> None:
        """Stop (if running) and close every subscriber."""
        if self._thread is not None:
            self.stop()
        with self._lock:
            for sub in self._subs:
                close = getattr(sub, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        self.push_errors += 1

    def __enter__(self) -> "TelemetryBridge":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- read side ---------------------------------------------------------

    def metrics(self) -> Dict:
        """JSON-ready cumulative view of every watched registry source —
        what ``/metrics`` serves."""
        from .schema import TELEMETRY_SCHEMA, encode_lanes
        with self._lock:
            return {
                "schema": TELEMETRY_SCHEMA,
                "session": self.session,
                "ts": now_ms(),
                "polls": self.polls,
                "deltas_total": self.deltas_total,
                "sources": {name: encode_lanes(cum)
                            for name, cum in self.cumulative.items()},
                "drain": {name: reg.drain_stats()
                          for name, reg in self._registries.items()},
                "findings": len(self.findings),
            }

    def findings_json(self) -> List[Dict]:
        """JSON-ready findings so far — what ``/findings`` serves."""
        with self._lock:
            return list(self.findings)
