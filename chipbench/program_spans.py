"""The per-layer metrics that read the program's own regions from the
Kineto trace of a traced serving run, on the card's clock: the
``serve/*`` regions of the port's ``generate`` (the cache's allocation,
the decode graph's capture, the prefill, its read-back, the decode steps
and the finish) and the ``moe/*`` spans of its MoE layer. Each metric's
file under ``metrics/`` binds one of these as its ``read``.

The regions are ``record_function`` spans (``user_annotation`` in the
trace) on the profiled window's thread, read with the frozen trace
reader. A reader returns None without a trace or without a call; a call
that lacks a region counts 0 for it, so a stretch taken off the path
reads 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .frozen.device_timeline import _Trace, _union
from .readers import _calls
from .tracing import kernels

CALL = "chipbench/call"
SERVE = "serve/"
PREFILL = "serve/prefill"
MOE = "moe/"
EXPERTS = "moe/experts"

Spans = List[Tuple[float, float]]


def _window_spans(tr: _Trace) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every host span on the window's thread."""
    spans = tr.spans.get(tr.window_tid)
    return spans.spans if spans is not None else []


def _minus(a: Spans, b: Spans) -> Spans:
    """The parts of the disjoint, sorted intervals ``a`` outside those of
    ``b``."""
    out = []
    for lo, hi in a:
        for x, y in b:
            if y <= lo or x >= hi:
                continue
            if x > lo:
                out.append((lo, x))
            lo = max(lo, y)
        if hi > lo:
            out.append((lo, hi))
    return out


def _length(spans: Spans) -> float:
    return sum(b - a for a, b in spans)


def region_ms(rec: Dict, name: str) -> Optional[float]:
    """Host ms of the trace's ``name`` spans, over the number of calls."""
    calls = _calls(rec)
    if not calls:
        return None
    spans = _window_spans(_Trace(rec["trace"]))
    us = sum(end - ts for ts, end, n in spans if n == name)
    return us / 1e3 / len(calls)


def alloc_cache_ms(rec: Dict) -> Optional[float]:
    """Mean host ms a call of ``serve/alloc_cache``: the caches."""
    return region_ms(rec, "serve/alloc_cache")


def capture_ms(rec: Dict) -> Optional[float]:
    """Mean host ms a call of ``serve/capture``: the decode graph's
    warm-up steps, capture and instantiation."""
    return region_ms(rec, "serve/capture")


def idle_unnamed_share(rec: Dict) -> Optional[float]:
    """Of the calls' idle time (inside ``chipbench/call`` spans, no
    kernel, copy or fill on the card), the share during which no
    ``serve/*`` span is open on the window's thread, in %; None where the
    calls hold no idle time."""
    if not _calls(rec):
        return None
    tr = _Trace(rec["trace"])
    spans = _window_spans(tr)
    calls = _union((ts, end) for ts, end, n in spans if n == CALL)
    named = _union((ts, end) for ts, end, n in spans if n.startswith(SERVE))
    idle = _minus(calls, _union((g.ts, g.end) for g in tr.gpu))
    total = _length(idle)
    if not total:
        return None
    return 100.0 * _length(_minus(idle, named)) / total


def _moe_prefill(rec: Dict) -> List[Tuple[str, float]]:
    """(innermost ``moe/*`` span, us) of the kernels, copies and fills
    launched under both ``serve/prefill`` and a ``moe/*`` span."""
    if not _calls(rec):
        return []
    out = []
    for k in kernels(rec, ""):
        moe = next((s for s in k["spans"] if s.startswith(MOE)), None)
        if moe is not None and PREFILL in k["spans"]:
            out.append((moe, k["us"]))
    return out


def moe_prefill_ms(rec: Dict) -> Optional[float]:
    """Mean device ms a call of the MoE layers' work in the prefill."""
    ks = _moe_prefill(rec)
    if not ks:
        return None
    return sum(us for _, us in ks) / 1e3 / len(_calls(rec))


def moe_expert_gemm_share(rec: Dict) -> Optional[float]:
    """The part of the MoE layers' prefill device time launched with
    ``moe/experts`` (the expert GEMMs and their activation) as the
    innermost ``moe/*`` span, in %."""
    ks = _moe_prefill(rec)
    total = sum(us for _, us in ks)
    if not total:
        return None
    return 100.0 * sum(us for moe, us in ks if moe == EXPERTS) / total
