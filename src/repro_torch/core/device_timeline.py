"""Device timeline on the card's own clock (timeline profiling, method 2).

The JAX package models its device timeline from compiled HLO, because no
TPU wall clock exists there. The H100 has one: :func:`profile` runs a
function once under ``torch.profiler`` (CPU and CUDA activity) and returns
the Kineto chrome trace, in which CUPTI's kernel, copy and fill records
share one time axis with the host's spans: ``record_function`` spans (the
comm layer's ``comm_*`` spans, and the port's regions while a profiler
runs) and the aten ops inside them.
Kernels are joined to host spans inside that trace only, by the
correlation id of the runtime call that launched them; never by time
against the collector's clock.

Lanes per device, as the reference's, so its exporters and analyses
apply unchanged (:func:`to_events`, :func:`overlay_match_lane`):

    tid 0  "compute stream"     kernels, copies and fills that are not
                                communication
    tid 1  "collective stream"  communication: work launched inside a
                                ``comm_*`` span, or on a side stream (one
                                the profiled thread never launched on:
                                the progress engine's, whose thread issues
                                on its own stream)
    tid 2  "match engine"       measured PRQ/UMQ search time laid under
                                the collectives that pay for it

:func:`extract_schedule` reads the segments of a trace. Overlap is
measured, not flagged by opcode: each collective interval is cut at the
edges of the compute lane's busy intervals, and a piece is ``overlapped``
when compute runs under it, so :func:`serialization_report`'s sums are
exact (``n_collectives`` counts pieces). :func:`device_report` gives the
busy and idle share of the profiled window, the kernels by total time,
the longest idle gaps with the host span open in each, and the time by
phase span and kernel class.

``Segment``, ``SerializationReport``, ``serialization_report``,
``to_events``, ``overlay_match_lane`` and ``MATCH_TID`` are copies of
``repro.core.device_timeline``'s; keep them in step.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .counters import CounterStat
from .events import Event
from .roofline import match_seconds

MATCH_TID = 2
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host calls that launch them (cuBLAS launches through the driver API)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host spans: record_function spans (the port's regions among them) and
# the aten ops inside them
SPAN_CATS = ("user_annotation", "cpu_op")
WINDOW = "device_timeline/window"
COMM_PREFIX = "comm_"
# kernel classes of device_report, by substrings of the kernel's name
KERNEL_CLASSES = (
    ("attention", ("flash_fwd", "flash_bwd")),
    ("scan", ("selective_scan",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("copy", ("Memcpy", "Memset")),
)


@dataclasses.dataclass
class Segment:
    name: str
    kind: str       # "compute" | "collective"
    t_cost: float   # seconds
    overlapped: bool = False


@dataclasses.dataclass
class SerializationReport:
    t_compute: float
    t_collective_total: float
    t_collective_exposed: float     # serialized (not overlapped) collective time
    n_collectives: int
    n_overlapped: int

    @property
    def exposed_fraction(self) -> float:
        if self.t_collective_total == 0:
            return 0.0
        return self.t_collective_exposed / self.t_collective_total

    @property
    def modeled_step_time(self) -> float:
        return self.t_compute + self.t_collective_exposed

    def summary(self) -> str:
        return (
            f"compute {self.t_compute * 1e3:.3f} ms, collective "
            f"{self.t_collective_total * 1e3:.3f} ms total / "
            f"{self.t_collective_exposed * 1e3:.3f} ms exposed "
            f"({self.exposed_fraction * 100:.1f}% serialized; "
            f"{self.n_overlapped}/{self.n_collectives} collectives async) -> "
            f"modeled step {self.modeled_step_time * 1e3:.3f} ms"
        )


def serialization_report(segments: List[Segment]) -> SerializationReport:
    t_comp = sum(s.t_cost for s in segments if s.kind == "compute")
    colls = [s for s in segments if s.kind == "collective"]
    t_coll = sum(s.t_cost for s in colls)
    exposed = sum(s.t_cost for s in colls if not s.overlapped)
    return SerializationReport(
        t_compute=t_comp,
        t_collective_total=t_coll,
        t_collective_exposed=exposed,
        n_collectives=len(colls),
        n_overlapped=sum(1 for s in colls if s.overlapped),
    )


def to_events(segments: List[Segment], pid: int = 0,
              time_scale: float = 1e9) -> List[Event]:
    """Lay segments onto two lanes (compute=tid 0, ICI=tid 1) as Events so
    the standard chrome-trace exporter and analyses apply."""
    events: List[Event] = []
    t_compute = 0.0   # frontier of compute lane (seconds)
    t_ici = 0.0
    for seg in segments:
        dur = seg.t_cost
        if seg.kind == "compute":
            t0 = t_compute
            t_compute += dur
            events.append(Event(
                name=seg.name, path=("step", seg.name), category="runtime",
                t_start=int(t0 * time_scale), t_end=int((t0 + dur) * time_scale),
                pid=pid, tid=0,
            ))
        else:
            if seg.overlapped:
                t0 = max(t_ici, t_compute - dur if t_compute > dur else t_ici)
                t_ici = t0 + dur
            else:
                t0 = max(t_compute, t_ici)        # serializes both lanes
                t_ici = t0 + dur
                t_compute = t_ici
            events.append(Event(
                name=seg.name, path=("step", seg.name), category="collective",
                t_start=int(t0 * time_scale), t_end=int(t_ici * time_scale),
                pid=pid, tid=1,
            ))
    return events


def overlay_match_lane(events: List[Event],
                       stats: Dict[str, CounterStat],
                       pid: int = 0, tid: int = MATCH_TID) -> List[Event]:
    """Project measured matching-engine time onto a modeled timeline.

    The method-2 counters measure how long the host-side matching path
    spent searching the PRQ/UMQ for the whole run; the modeled timeline
    knows which collectives the compiled step executes and how long each
    rides the wire. Apportion the measured seconds over the modeled
    collective events in proportion to their wire time and lay them on a
    third "match engine" lane, so a defective engine literally widens the
    matching track under the collective that pays for it.

    Returns the new lane's events (append them to ``events`` before
    exporting); empty when there are no collectives or no measured time.
    """
    total_s = match_seconds(stats)
    colls = [e for e in events if e.category == "collective"
             and e.pid == pid]
    if not colls or total_s <= 0:
        return []
    t_wire = sum(e.duration for e in colls) or len(colls)
    depth = stats.get("match.prq.traversal_depth")
    umq = stats.get("match.umq.length")
    out: List[Event] = []
    for e in colls:
        share = (e.duration or 1) / t_wire
        dur = int(total_s * share * 1e9)
        attrs = {"share": share, "match_s_total": total_s}
        if depth is not None and depth.count:
            attrs["prq_depth_mean"] = depth.mean
        if umq is not None and umq.count:
            attrs["umq_len_max"] = umq.vmax
        out.append(Event(
            name=f"match/{e.name}", path=("step", "match", e.name),
            category="match", t_start=e.t_start, t_end=e.t_start + dur,
            pid=pid, tid=tid, attrs=attrs,
        ))
    return out


# ---------------------------------------------------------------------------
# the profiled run and its trace
# ---------------------------------------------------------------------------

def profile(fn, *args: Any, **kwargs: Any) -> Tuple[Any, dict]:
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` (CPU and
    CUDA activity) inside a :data:`WINDOW` span that ends after the card
    has finished; return (its result, the Kineto chrome trace as a dict).

    Raises without a card, and when the trace holds no kernel (CUPTI
    missing, or launches it cannot see): there is no fallback to a
    modeled or host timeline."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA card: the device timeline "
                           "is read from the card's own clock")
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    if not any(e.get("cat") == "kernel" for e in trace.get("traceEvents", [])):
        raise RuntimeError("the profiler recorded no CUDA kernel")
    return result, trace


@dataclasses.dataclass
class _Gpu:
    """One kernel, copy or fill on the card (times in microseconds)."""
    name: str
    ts: float
    end: float
    stream: int
    launch: Optional[Tuple[float, Any]]     # (ts, tid) of its runtime call
    label: str = ""                         # a collective's name
    collective: bool = False


class _Spans:
    """The host's spans of one thread, nested: the innermost span open at
    a moment, and its enclosing spans."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in spans]
        self.spans = spans
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (ts, end, _name) in enumerate(spans):
            while stack and spans[stack[-1]][1] < ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: float) -> List[str]:
        """Names of the spans open at ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out


class _Trace:
    """A Kineto trace, parsed: the card's events in time order
    (communication flagged), the host spans by thread, the profiled window
    and its thread, and the side streams.

    A side stream is one that the window's thread launched nothing on
    (none where the trace holds none of that thread's launches).
    CUPTI records every thread's runtime calls, but a thread started
    before the profiler (the progress engine's) has no host spans in the
    trace, and its runtime calls carry an id of CUPTI's rather than its
    native id; so its work is known by its stream, not by its thread or
    its ``comm_*`` spans."""

    def __init__(self, trace: dict):
        events = trace.get("traceEvents", [])
        launches: Dict[Any, Tuple[float, Any]] = {}
        by_tid: Dict[Any, List[Tuple[float, float, str]]] = {}
        self.window: Optional[Tuple[float, float]] = None
        self.window_tid = None
        gpu = []
        for e in events:
            cat, args = e.get("cat"), e.get("args") or {}
            if e.get("ph") != "X":
                continue
            ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if cat in GPU_CATS:
                gpu.append((e, ts, end, args))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat in SPAN_CATS:
                by_tid.setdefault(e.get("tid"), []).append(
                    (ts, end, e["name"]))
                if e["name"] == WINDOW:
                    self.window, self.window_tid = (ts, end), e.get("tid")
        self.spans = {tid: _Spans(s) for tid, s in by_tid.items()}
        self.gpu: List[_Gpu] = []
        for e, ts, end, args in sorted(gpu, key=lambda g: g[1]):
            launch = launches.get(args.get("correlation"))
            comm = next((n for n in self.chain(launch)
                         if n.startswith(COMM_PREFIX)), None)
            self.gpu.append(_Gpu(e["name"], ts, end, args.get("stream"),
                                 launch, label=comm or e["name"],
                                 collective=comm is not None))
        callers = {g.stream for g in self.gpu if g.launch is not None
                   and g.launch[1] == self.window_tid}
        # without the window's own launches in the trace, no stream can
        # be told to be a side stream
        self.side_streams = (sorted({g.stream for g in self.gpu} - callers,
                                    key=str) if callers else [])
        for g in self.gpu:
            g.collective = g.collective or g.stream in self.side_streams

    def chain(self, launch: Optional[Tuple[float, Any]]) -> List[str]:
        """The host spans open at a runtime call on its thread, innermost
        first."""
        if launch is None or launch[1] not in self.spans:
            return []
        return self.spans[launch[1]].chain(launch[0])

    def bounds(self) -> Tuple[float, float]:
        if self.window is not None:
            return self.window
        return (min(g.ts for g in self.gpu), max(g.end for g in self.gpu))


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _cut(a: float, b: float, busy: List[Tuple[float, float]]
         ) -> List[Tuple[float, float, bool]]:
    """[a, b) cut at the edges of the disjoint sorted ``busy`` intervals:
    (start, end, inside busy) pieces of non-zero length."""
    pieces, t = [], a
    i = max(0, bisect.bisect_right([x for x, _ in busy], a) - 1)
    for x, y in busy[i:]:
        if x >= b:
            break
        if y <= t:
            continue
        if x > t:
            pieces.append((t, x, False))
            t = x
        hi = min(y, b)
        if hi > t:
            pieces.append((t, hi, True))
            t = hi
    if b > t:
        pieces.append((t, b, False))
    return pieces


def extract_schedule(trace: dict) -> List[Segment]:
    """The card's work in a Kineto trace as segments, in time order.

    Consecutive compute events merge into one segment between collectives
    (its cost their busy time, each instant once); each collective event
    becomes one segment per piece of it cut at the compute lane's busy
    edges, ``overlapped`` where compute runs under the piece."""
    tr = _Trace(trace)
    busy = _union((g.ts, g.end) for g in tr.gpu if not g.collective)
    segments: List[Segment] = []
    pending, frontier = 0.0, float("-inf")

    def flush():
        nonlocal pending
        if pending:
            segments.append(Segment("compute", "compute", pending * 1e-6))
            pending = 0.0

    for g in tr.gpu:
        if not g.collective:
            pending += max(0.0, g.end - max(g.ts, frontier))
            frontier = max(frontier, g.end)
            continue
        flush()
        for a, b, under in _cut(g.ts, g.end, busy):
            segments.append(Segment(g.label, "collective", (b - a) * 1e-6,
                                    overlapped=under))
    flush()
    return segments


def side_streams(trace: dict) -> List[Any]:
    """The streams that the profiled thread launched nothing on, whose
    work counts as communication (in the port, the progress engine's)."""
    return _Trace(trace).side_streams


def _kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def device_report(trace: dict, top: int = 10, gaps: int = 5,
                  phases: Sequence[str] = ()) -> Dict[str, Any]:
    """What the card did in the profiled window.

    ``window_ms`` (the :data:`WINDOW` span, else first to last event),
    ``busy_ms`` (the union of every kernel, copy and fill), their busy and
    idle shares; ``kernels``: the ``top`` names by total ms with launch
    counts; ``idle_gaps``: the ``gaps`` longest stretches with nothing on
    the card, each with the innermost host span open on the window's
    thread at its middle (``host``, None where none is open) and the spans
    around it (``host_path``, innermost first); ``streams``: busy ms,
    events and communication events by stream; ``by_phase``: ms by kernel class
    (:data:`KERNEL_CLASSES`) under the spans named in ``phases`` that
    contain each event's launch in time, on any thread, joined outer to
    inner with " > " ("" where none does)."""
    tr = _Trace(trace)
    lo, hi = tr.bounds()
    window = hi - lo
    busy = [(max(a, lo), min(b, hi)) for a, b in
            _union((g.ts, g.end) for g in tr.gpu)]
    busy = [(a, b) for a, b in busy if b > a]
    busy_us = sum(b - a for a, b in busy)

    kernels: Dict[str, List[float]] = {}
    streams: Dict[Any, Dict[str, float]] = {}
    for g in tr.gpu:
        k = kernels.setdefault(g.name, [0.0, 0])
        k[0] += g.end - g.ts
        k[1] += 1
    for s in sorted({g.stream for g in tr.gpu}, key=str):
        on = [g for g in tr.gpu if g.stream == s]
        streams[s] = {"ms": sum(b - a for a, b in
                                _union((g.ts, g.end) for g in on)) / 1e3,
                      "events": len(on),
                      "collective_events": sum(g.collective for g in on)}
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])

    idle, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    idle.sort(key=lambda ab: -(ab[1] - ab[0]))
    host = tr.spans.get(tr.window_tid)
    gap_rows = []
    for a, b in idle[:gaps]:
        path = host.chain((a + b) / 2) if host is not None else []
        path = [n for n in path if n != WINDOW]
        gap_rows.append({"ms": (b - a) / 1e3, "at_ms": (a - lo) / 1e3,
                         "host": path[0] if path else None,
                         "host_path": path})

    by_phase: Dict[str, Dict[str, float]] = {}
    if phases:
        spans = {}
        for tid_spans in tr.spans.values():
            for ts, end, name in tid_spans.spans:
                if name in phases:
                    spans.setdefault(name, []).append((ts, end))
        for g in tr.gpu:
            inside = []
            if g.launch is not None:
                t0 = g.launch[0]
                for name, ivs in spans.items():
                    for ts, end in ivs:
                        if ts <= t0 <= end:
                            inside.append((ts - end, name))
                            break
            key = " > ".join(name for _, name in sorted(inside))
            row = by_phase.setdefault(key, {})
            cls = _kernel_class(g.name)
            row[cls] = row.get(cls, 0.0) + (g.end - g.ts) / 1e3
    return {
        "window_ms": window / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window if window else 0.0,
        "idle_share": 1.0 - busy_us / window if window else 0.0,
        "events": len(tr.gpu),
        "kernels": [{"name": n, "ms": ms / 1e3, "launches": c}
                    for n, (ms, c) in ranked[:top]],
        "idle_gaps": gap_rows,
        "streams": {str(s): v for s, v in streams.items()},
        "by_phase": by_phase,
    }


def launches_by_symbol(trace: dict, symbols: Sequence[str]) -> Dict[str, int]:
    """How many kernels in the trace have each of ``symbols`` in their
    (demangled) name."""
    names = [e["name"] for e in trace.get("traceEvents", [])
             if e.get("cat") == "kernel" and e.get("ph") == "X"]
    return {s: sum(s in n for n in names) for s in symbols}
