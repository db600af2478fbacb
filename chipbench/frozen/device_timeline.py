"""The Kineto trace reader and kernel classifier of the device timeline.

Copied from ``src/repro_torch/core/device_timeline.py`` at commit 5ccc2ae:
``profile``, ``_Gpu``, ``_Spans``, ``_Trace``, ``_union``,
``_kernel_class`` and ``device_report`` verbatim, with the constants they
read. Left out: the modeled schedule, the serialization report and the
match lane, which read no trace. ``kernel_events`` is the benchmark's
own: every kernel with the host spans open at its launch.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

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


def kernel_events(trace: dict) -> List[Dict[str, Any]]:
    """Every kernel, copy and fill in the trace, in time order: ``name``,
    ``us`` (its duration), and ``spans``, the host spans open at its
    launch on the launching thread, innermost first."""
    tr = _Trace(trace)
    return [{"name": g.name, "us": g.end - g.ts, "spans": tr.chain(g.launch)}
            for g in tr.gpu]
