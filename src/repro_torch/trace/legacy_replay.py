"""Frozen pre-overhaul replayer — the replay bench's yardstick.

This is the trace replay path exactly as it stood before the trace
pipeline overhaul (schema v3 + batched streaming replay): the whole
record list is materialized eagerly by :func:`repro_torch.trace.io.read_trace`
and every recorded op is re-driven through one per-op python engine call
(``post_recv``/``arrive``), with per-op match-order verification against
the recorded outcomes. The semantics are identical to the live
:class:`repro_torch.trace.replay.Replayer` — per-phase/per-rank counter
statistics and detector findings agree cell-for-cell — only the cost
differs, which is the point: ``benchmarks/replay_bench.py`` drives every
scenario's recorded trace through both replayers *interleaved in the
same process* and gates on the throughput ratio, so the speedup
measurement is immune to machine-load swings.

Do not "fix" or optimize this module; it is a measurement reference.

A copy of ``repro.trace.legacy_replay``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

from ..core.counters import CounterRegistry, CounterStat, counter_stats
from ..core.events import Event
from ..match import MatchEngine, canonical_mode
from .io import _open
from .replay import (PHASE_NS, PhaseStats, ReplayResult, _parse_snap,
                     replay_progress)
from .schema import (_REQUIRED, REC_ARRIVE, REC_PHASE, REC_POST,
                     REC_PROGRESS, REC_SNAPSHOT, TraceSchemaError,
                     validate_header)


def _validate_record(rec: Dict) -> Dict:
    """The pre-overhaul ``validate_record``: a field-list scan per
    record (the live reader has since moved to one C-level subset
    check)."""
    kind = rec.get("t")
    if kind not in _REQUIRED:
        raise TraceSchemaError(f"unknown record type {kind!r}")
    missing = [f for f in _REQUIRED[kind] if f not in rec]
    if missing:
        raise TraceSchemaError(
            f"{kind!r} record missing required field(s) {missing}")
    return rec


def legacy_read_trace(path: str) -> Tuple[Dict, List[Dict]]:
    """The pre-overhaul eager reader: one ``json.loads`` + validation
    per line, the whole record list materialized up front. Speaks every
    per-op schema (v1/v2) — chunked v3 traces belong to the streaming
    reader this module is the yardstick for."""
    header: Optional[Dict] = None
    records: List[Dict] = []
    with _open(str(path), write=False) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if header is None:
                header = validate_header(rec)
            else:
                records.append(_validate_record(rec))
    if header is None:
        raise TraceSchemaError(f"empty trace file (no header): {path}")
    return header, records


class LegacyRegistry(CounterRegistry):
    """The pre-overhaul counter drain, frozen: per-delta double stat
    updates with three dict lookups each, dataclass-construction of
    fresh stats, and copy-then-clear snapshots. This PR's overhaul
    re-tuned all of that for replay volume (per-pid pair cache,
    columnar/distinct-value folds, zero-copy ``snapshot_lanes``), so
    the yardstick carries its own copy — the same treatment
    ``match/legacy.py`` gave the engine."""

    def _merge(self, flat) -> None:
        merged = self._merged
        by_pid = self._merged_by_pid
        it = iter(flat)
        for pid, name, value, obs in zip(it, it, it, it):
            if type(obs) is str:          # column record: name=spec,
                per = by_pid.get(pid)     # value=row-major values
                if per is None:
                    per = by_pid[pid] = {}
                cols = []
                for cname, cobs in name:
                    st = merged.get(cname)
                    if st is None:
                        st = merged[cname] = CounterStat(name=cname)
                    pst = per.get(cname)
                    if pst is None:
                        pst = per[cname] = CounterStat(name=cname)
                    cols.append((st, pst, cobs))
                k = len(cols)
                i = 0
                for v in value:
                    st, pst, cobs = cols[i]
                    i += 1
                    if i == k:
                        i = 0
                    st.count += 1
                    st.total += v
                    pst.count += 1
                    pst.total += v
                    if cobs:
                        iv = int(v)
                        b = 1 << (iv.bit_length() - 1) if iv > 0 else 0
                        st.kind = "histogram"
                        if v < st.vmin:
                            st.vmin = v
                        if v > st.vmax:
                            st.vmax = v
                        bins = st.bins
                        bins[b] = bins.get(b, 0) + 1
                        pst.kind = "histogram"
                        if v < pst.vmin:
                            pst.vmin = v
                        if v > pst.vmax:
                            pst.vmax = v
                        bins = pst.bins
                        bins[b] = bins.get(b, 0) + 1
                continue
            st = merged.get(name)
            if st is None:
                st = merged[name] = CounterStat(name=name)
            per = by_pid.get(pid)
            if per is None:
                per = by_pid[pid] = {}
            pst = per.get(name)
            if pst is None:
                pst = per[name] = CounterStat(name=name)
            st.count += 1
            st.total += value
            pst.count += 1
            pst.total += value
            if obs:
                v = int(value)
                b = 1 << (v.bit_length() - 1) if v > 0 else 0
                st.kind = "histogram"
                if value < st.vmin:
                    st.vmin = value
                if value > st.vmax:
                    st.vmax = value
                bins = st.bins
                bins[b] = bins.get(b, 0) + 1
                pst.kind = "histogram"
                if value < pst.vmin:
                    pst.vmin = value
                if value > pst.vmax:
                    pst.vmax = value
                bins = pst.bins
                bins[b] = bins.get(b, 0) + 1

    def snapshot_lanes(self) -> Dict[int, Dict[str, CounterStat]]:
        # pre-overhaul form: drain_lanes copies every lane dict, then
        # the merged aggregates are cleared
        lanes = self.drain_lanes()
        with self._registry_lock:
            self._merged = {}
            self._merged_by_pid = {}
        return lanes


class LegacyReplayer:
    """Pre-overhaul replay: eager record list, one python dispatch per
    recorded op. Same constructor contract as the pre-overhaul
    ``Replayer`` (mode / progress_mode / phase_ns)."""

    def __init__(self, mode: Optional[str] = None,
                 progress_mode: Optional[str] = None,
                 phase_ns: int = PHASE_NS):
        self.mode = mode
        self.progress_mode = progress_mode
        self.phase_ns = phase_ns

    def run(self, source: Union[str, Tuple[Dict, List[Dict]]]
            ) -> ReplayResult:
        if isinstance(source, (tuple, list)):
            header, records = source
        else:
            header, records = legacy_read_trace(source)
        mode = canonical_mode(self.mode or header.get("mode", "binned"))

        registry = LegacyRegistry()
        engines: Dict[int, MatchEngine] = {}

        def engine(rank: int) -> MatchEngine:
            eng = engines.get(rank)
            if eng is None:
                eng = engines[rank] = MatchEngine(
                    rank=rank, mode=mode, registry=registry.lane(rank))
            return eng

        phases: List[PhaseStats] = []
        events: List[Event] = []
        matches: List[Tuple[int, str, int, Optional[int]]] = []
        divergences: List[Dict] = []
        pe_records: List[Dict] = []
        recorded_stats: Optional[Dict[int, Dict[str, CounterStat]]] = None
        current = PhaseStats(index=0, label="prologue", op="phase")
        wall: List[int] = []          # t_wall stamps seen in current phase

        def flush_phase() -> None:
            t = (len(phases) + 1) * self.phase_ns
            evs = registry.snapshot_events(t_ns=t)
            per: Dict[int, List[Event]] = {}
            for ev in evs:
                ev.attrs["phase"] = current.label
                ev.attrs["phase_index"] = current.index
                per.setdefault(ev.pid, []).append(ev)
            current.stats = {pidx: counter_stats(group)
                             for pidx, group in per.items()}
            if wall:
                current.wall_ns = max(wall) - min(wall)
                del wall[:]
            phases.append(current)
            events.extend(evs)

        for rec in records:
            kind = rec["t"]
            if "t_wall" in rec:
                wall.append(rec["t_wall"])
            if kind == REC_PHASE:
                flush_phase()
                current = PhaseStats(
                    index=len(phases), label=rec["label"], op=rec["op"],
                    attrs={k: v for k, v in rec.items()
                           if k not in ("t", "op", "label")})
            elif kind == REC_POST:
                r = engine(rec["rank"]).post_recv(
                    src=rec["src"], tag=rec["tag"], comm=rec.get("comm", 0))
                got = r.message.seq if r.message is not None else None
                matches.append((rec["rank"], "post", r.seq, got))
                if "hit" in rec and rec["hit"] != got:
                    divergences.append(
                        {"rec": rec, "replayed": got, "mode": mode})
            elif kind == REC_ARRIVE:
                r = engine(rec["rank"]).arrive(
                    src=rec["src"], tag=rec["tag"],
                    comm=rec.get("comm", 0), nbytes=rec.get("nb", 0))
                got = r.seq if r is not None else None
                matches.append((rec["rank"], "arr", rec["seq"], got))
                if "match" in rec and rec["match"] != got:
                    divergences.append(
                        {"rec": rec, "replayed": got, "mode": mode})
            elif kind == REC_PROGRESS:
                pe_records.append(rec)
            elif kind == REC_SNAPSHOT:
                recorded_stats = _parse_snap(rec)
        flush_phase()

        progress_mode = self.progress_mode
        progress_events: List[Event] = []
        if pe_records:
            progress_mode = progress_mode or "incoming"
            progress_events = replay_progress(pe_records, progress_mode)
            events.extend(progress_events)

        return ReplayResult(
            mode=mode, progress_mode=progress_mode, header=header,
            matches=matches, divergences=divergences, phases=phases,
            events=events, progress_events=progress_events,
            pe_records=pe_records, registry=registry,
            recorded_stats=recorded_stats, n_ops=len(matches))


def legacy_replay(source: Union[str, Tuple[Dict, List[Dict]]],
                  mode: Optional[str] = None,
                  progress_mode: Optional[str] = None) -> ReplayResult:
    """One-call frozen replay: ``legacy_replay(path, mode="linear")``."""
    return LegacyReplayer(mode=mode, progress_mode=progress_mode
                          ).run(source)
