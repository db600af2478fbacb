"""What a traced run reports of the card: its busy and window seconds,
the breakdown of its time, and the kernels by name, read from the
Kineto trace by the frozen trace reader."""
from __future__ import annotations

from typing import Dict, List

from .frozen.device_timeline import device_report, kernel_events


def device_times(trace: dict) -> Dict[str, float]:
    rep = device_report(trace, top=0, gaps=0)
    return {"busy_s": rep["busy_ms"] / 1e3, "window_s": rep["window_ms"] / 1e3}


def breakdown(trace: dict, top: int = 10) -> Dict[str, List]:
    """The ``top`` device operations by total seconds and the ``top``
    longest idle gaps, each named by the host span open in it."""
    rep = device_report(trace, top=top, gaps=top)
    return {"device_ops": [[k["name"], k["ms"] / 1e3] for k in rep["kernels"]],
            "idle_gaps": [[g["host"] or "no span", g["ms"] / 1e3]
                          for g in rep["idle_gaps"]]}


def kernels(record: Dict, substring: str, exclude: str = "") -> List[Dict]:
    """The trace's kernels whose name holds ``substring`` (and not
    ``exclude``), or [] without a trace."""
    if record.get("trace") is None:
        return []
    return [k for k in kernel_events(record["trace"])
            if substring in k["name"] and not (exclude and exclude in k["name"])]


def busy_within(trace: dict, span: str) -> Dict[str, float]:
    """Seconds of the host spans named ``span`` (their union) and of the
    card's busy time inside them."""
    from .frozen.device_timeline import _Trace, _union

    tr = _Trace(trace)
    spans = _union((ts, end) for s in tr.spans.values()
                   for ts, end, name in s.spans if name == span)
    busy = _union((g.ts, g.end) for g in tr.gpu)
    inside = 0.0
    for a, b in spans:
        for x, y in busy:
            lo, hi = max(a, x), min(b, y)
            if hi > lo:
                inside += hi - lo
    return {"span_s": sum(b - a for a, b in spans) / 1e6, "busy_s": inside / 1e6}
