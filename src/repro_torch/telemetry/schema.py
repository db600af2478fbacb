"""Telemetry frame schema (version 1).

The live bridge streams the same per-pid counter lanes the post-hoc path
reads out of :meth:`CounterRegistry.snapshot_lanes`, as schema-versioned
JSON frames — one object per frame, JSONL on disk, ``data:`` lines over
SSE. The encoding borrows the trace schema v3 idioms: single-char frame
tags, short keys, values collapsed to ints when exact, stats packed as
positional columns instead of attr dicts.

Frame kinds (tag ``t``):

  ``th``  header  — once per session: schema version, poll period, the
                    watched source names. Everything needed to interpret
                    the frames that follow.
  ``td``  delta   — one poll of one source: per-pid lane stats for
                    counters that moved since the previous poll, plus the
                    registry's drain-epoch metadata (no-loss accounting).
  ``tf``  finding — a detector verdict that first became true this poll
                    (``umq_flood`` / ``long_traversal`` / ``contention``).
  ``te``  end     — session summary: polls, deltas, findings.

Stat packing (``encode_stat`` / ``decode_stat``):

  counter    -> [count, total]
  histogram  -> [count, total, vmin, vmax, [bin, n, bin, n, ...]]

Floats that are exactly integral are written as ints (JSON compactness;
round-trips exactly). Pids become JSON object keys, so they travel as
strings and are restored to ints on decode.

A copy of ``repro.telemetry.schema``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.counters import CounterStat

TELEMETRY_SCHEMA = 1
TELEMETRY_FORMAT = "repro-telemetry"

FRAME_HEADER = "th"
FRAME_DELTA = "td"
FRAME_FINDING = "tf"
FRAME_END = "te"

FRAME_KINDS = (FRAME_HEADER, FRAME_DELTA, FRAME_FINDING, FRAME_END)

Lanes = Dict[int, Dict[str, CounterStat]]


class TelemetryFrameError(ValueError):
    """A frame that does not decode under this schema."""


def _num(v: float) -> object:
    """Collapse integral floats to ints (same compactness trick the v3
    trace codecs use for timestamps)."""
    iv = int(v)
    return iv if iv == v else v


def encode_stat(st: CounterStat) -> List:
    """Pack one stat as a positional column (see module docstring)."""
    if st.kind != "histogram":
        return [st.count, _num(st.total)]
    bins: List = []
    for b in sorted(st.bins):
        bins.append(b)
        bins.append(st.bins[b])
    return [st.count, _num(st.total), _num(st.vmin), _num(st.vmax), bins]


def decode_stat(name: str, enc: Sequence) -> CounterStat:
    if not isinstance(enc, (list, tuple)) or len(enc) not in (2, 5):
        raise TelemetryFrameError(
            f"stat column for {name!r} must have 2 or 5 fields, got {enc!r}")
    st = CounterStat(name=name, count=int(enc[0]), total=float(enc[1]))
    if len(enc) == 5:
        st.kind = "histogram"
        st.vmin = float(enc[2])
        st.vmax = float(enc[3])
        flat = enc[4]
        st.bins = {int(flat[i]): int(flat[i + 1])
                   for i in range(0, len(flat), 2)}
    return st


def encode_lanes(lanes: Lanes) -> Dict[str, Dict[str, List]]:
    """Per-pid lanes as a JSON-ready nested object. Copies values out of
    the stats, so callers may keep mutating the originals (the bridge
    merges the same objects into its cumulative view after encoding)."""
    return {str(pid): {name: encode_stat(st)
                       for name, st in sorted(lanes[pid].items())}
            for pid in sorted(lanes)}


def decode_lanes(enc: Dict[str, Dict[str, Sequence]]) -> Lanes:
    return {int(pid): {name: decode_stat(name, col)
                       for name, col in per.items()}
            for pid, per in enc.items()}


def now_ms() -> int:
    return time.time_ns() // 1_000_000


def make_telemetry_header(session: str, period_s: float,
                          sources: Sequence[str]) -> Dict:
    return {"t": FRAME_HEADER, "format": TELEMETRY_FORMAT,
            "v": TELEMETRY_SCHEMA, "session": session,
            "period_s": period_s, "sources": list(sources),
            "ts": now_ms()}


def make_delta_frame(seq: int, source: str, lanes: Lanes,
                     meta: Optional[Dict] = None,
                     ts: Optional[int] = None) -> Dict:
    frame = {"t": FRAME_DELTA, "q": seq, "ts": now_ms() if ts is None else ts,
             "src": source, "l": encode_lanes(lanes)}
    if meta:
        frame["m"] = meta
    return frame


def make_finding_frame(seq: int, source: str, finding: Dict,
                       ts: Optional[int] = None) -> Dict:
    """``finding`` is the JSON-ready ``Finding.to_dict()`` payload."""
    frame = {"t": FRAME_FINDING, "q": seq,
             "ts": now_ms() if ts is None else ts, "src": source}
    frame.update(finding)
    return frame


def make_end_frame(seq: int, polls: int, deltas: int, findings: int,
                   ts: Optional[int] = None) -> Dict:
    return {"t": FRAME_END, "q": seq, "ts": now_ms() if ts is None else ts,
            "polls": polls, "deltas": deltas, "findings": findings}


def validate_frame(frame: Dict) -> str:
    """Return the frame kind, raising :class:`TelemetryFrameError` when
    the frame is not interpretable under this schema."""
    kind = frame.get("t")
    if kind not in FRAME_KINDS:
        raise TelemetryFrameError(f"unknown telemetry frame kind {kind!r}")
    if kind == FRAME_HEADER:
        if frame.get("format") != TELEMETRY_FORMAT:
            raise TelemetryFrameError(
                f"not a telemetry stream: format={frame.get('format')!r}")
        if frame.get("v") != TELEMETRY_SCHEMA:
            raise TelemetryFrameError(
                f"unsupported telemetry schema v{frame.get('v')!r}")
    elif kind == FRAME_DELTA:
        for key in ("q", "src", "l"):
            if key not in frame:
                raise TelemetryFrameError(f"delta frame missing {key!r}")
    elif kind == FRAME_FINDING:
        for key in ("q", "kind", "message", "severity"):
            if key not in frame:
                raise TelemetryFrameError(f"finding frame missing {key!r}")
    return kind


def frame_lanes(frame: Dict) -> Lanes:
    """Decode a delta frame's lanes back into CounterStat lanes."""
    if frame.get("t") != FRAME_DELTA:
        raise TelemetryFrameError(
            f"frame kind {frame.get('t')!r} carries no lanes")
    return decode_lanes(frame["l"])


def dumps(frame: Dict) -> str:
    """One frame as a compact JSON line (no trailing newline)."""
    return json.dumps(frame, separators=(",", ":"), sort_keys=False)
