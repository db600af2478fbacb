"""Chrome trace-event export/import (paper §4, Figs 7-9).

Events are exported as 'X' (complete) events in the Chromium trace-event
JSON format, viewable in chrome://tracing or Perfetto — the same viewers
the paper's Caliper traces target. pid = MPI-rank analog (device / process
index), tid = thread (user thread vs progress/async stream).

A copy of ``repro.core.timeline``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import gzip
import json
from typing import Dict, Iterable, List, Optional, Sequence

from .events import Event


def to_chrome_trace(
    events: Iterable[Event],
    pid: Optional[int] = None,
    process_names: Optional[Dict[int, str]] = None,
    thread_names: Optional[Dict[int, str]] = None,
) -> dict:
    trace_events: List[dict] = []
    seen_pids, seen_tids = set(), set()
    for ev in events:
        epid = pid if pid is not None else ev.pid
        seen_pids.add(epid)
        seen_tids.add((epid, ev.tid))
        rec = {
            "name": ev.name,
            "cat": ev.category,
            "ph": "X",
            "ts": ev.t_start / 1000.0,          # chrome uses microseconds
            "dur": ev.duration / 1000.0,
            "pid": epid,
            "tid": ev.tid,
        }
        args = dict(ev.attrs or {})
        args["path"] = "/".join(ev.path)
        rec["args"] = args
        trace_events.append(rec)
    # metadata records (names shown in the viewer)
    for p in sorted(seen_pids):
        name = (process_names or {}).get(p, f"rank {p}")
        trace_events.append({"name": "process_name", "ph": "M", "pid": p,
                             "args": {"name": name}})
    for p, t in sorted(seen_tids):
        name = (thread_names or {}).get(t, "user thread" if t == 0 else f"thread {t}")
        trace_events.append({"name": "thread_name", "ph": "M", "pid": p, "tid": t,
                             "args": {"name": name}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def from_chrome_trace(trace: dict) -> List[Event]:
    out: List[Event] = []
    for rec in trace.get("traceEvents", []):
        if rec.get("ph") != "X":
            continue
        args = rec.get("args", {}) or {}
        path = tuple(args.get("path", rec["name"]).split("/"))
        attrs = {k: v for k, v in args.items() if k != "path"} or None
        t0 = int(round(rec["ts"] * 1000.0))
        out.append(
            Event(
                name=rec["name"],
                path=path,
                category=rec.get("cat", "app"),
                t_start=t0,
                t_end=t0 + int(round(rec.get("dur", 0) * 1000.0)),
                pid=int(rec.get("pid", 0)),
                tid=int(rec.get("tid", 0)),
                attrs=attrs,
            )
        )
    out.sort(key=lambda e: (e.t_start, e.t_end))
    return out


def merge_traces(traces: Sequence[dict]) -> dict:
    """Merge per-rank traces into one (ranks keep their pid lanes)."""
    merged: List[dict] = []
    for tr in traces:
        merged.extend(tr.get("traceEvents", []))
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def save_trace(trace: dict, path: str) -> None:
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(trace, f)
    else:
        with open(path, "w") as f:
            json.dump(trace, f)


def load_trace(path: str) -> dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)
