"""Wire/manifest codec for sharded replay and the trace corpus.

Shard workers and the corpus manifest both need replay results in a
compact, picklable / JSON-committable form. Rather than invent a new
stat encoding, this reuses the telemetry frame codec
(:mod:`repro_torch.telemetry.schema`): a counter packs to ``[count, total]``,
a histogram to ``[count, total, vmin, vmax, [bin, n, ...]]``, with
integral floats collapsed to ints — so two encodings are equal exactly
when the stats are equal, which makes *encoded* signatures the safe
thing to compare (no float-representation subtleties) and the safe
thing to commit.

Two views of one replay:

  * :func:`encode_shard` / :func:`merge-side decode <decode_phases>` —
    the full per-phase lane stats (timing counters included), the
    transport between shard workers and the merge step in
    :mod:`repro_torch.corpus.parallel`.
  * :func:`signature` — per-phase stats filtered to the
    :data:`DETERMINISTIC_COUNTERS` (queue depths/lengths and hit
    counts; never ``*_ns`` timing, which varies run to run), plus phase
    identity. This is what the corpus manifest commits and what the
    runner compares bit-for-bit.

A copy of ``repro.corpus.codec``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import analyses
from ..core.counters import CounterRegistry
from ..telemetry.schema import (decode_lanes, decode_stat, encode_lanes,
                                encode_stat)
from ..trace.replay import PhaseStats, ReplayResult

# Counter names whose replayed statistics are exact functions of the
# recorded op stream (given an engine mode) — the comparable surface for
# shard-vs-serial equivalence and corpus regression gating. Timing
# counters (match.*.search_ns) are measured, hence excluded everywhere.
# This is the canonical home; workloads.replaybench aliases it.
DETERMINISTIC_COUNTERS = (
    "match.expected", "match.unexpected", "match.umq.hit",
    "match.umq.leaked", "match.prq.traversal_depth",
    "match.umq.traversal_depth", "match.prq.length", "match.umq.length")


def encode_phases(phases: Sequence[PhaseStats],
                  counters: Optional[Sequence[str]] = None) -> List:
    """Phases as JSON-ready rows ``[index, label, op, wall_ns, attrs,
    lanes]``; ``counters`` filters the stat names (pass
    :data:`DETERMINISTIC_COUNTERS` for the committable signature)."""
    out: List = []
    for ph in phases:
        lanes = ph.stats
        if counters is not None:
            keep = frozenset(counters)
            lanes = {pid: {n: st for n, st in per.items() if n in keep}
                     for pid, per in lanes.items()}
        out.append([ph.index, ph.label, ph.op, ph.wall_ns, ph.attrs,
                    encode_lanes(lanes)])
    return out


def decode_phases(enc: Sequence) -> List[PhaseStats]:
    return [PhaseStats(index=row[0], label=row[1], op=row[2],
                       wall_ns=row[3], attrs=row[4] or {},
                       stats=decode_lanes(row[5]))
            for row in enc]


def signature(res: ReplayResult) -> List:
    """The committable / comparable replay signature: per phase,
    ``[index, label, op, wall_ns, {pid: [col, ...]}]`` with one
    positional column per :data:`DETERMINISTIC_COUNTERS` entry (``0``
    when the counter never fired). Positional columns keep the
    committed manifest ~3× smaller than named lanes — the counter
    names appear once, in this module, not once per (phase, rank)."""
    out: List = []
    for ph in res.phases:
        lanes = {}
        for pid in sorted(ph.stats):
            per = ph.stats[pid]
            cols: List = []
            for name in DETERMINISTIC_COUNTERS:
                st = per.get(name)
                cols.append(encode_stat(st) if st is not None else 0)
            lanes[str(pid)] = cols
        out.append([ph.index, ph.label, ph.op, ph.wall_ns, lanes])
    return out


def signature_phases(sig: Sequence) -> List[PhaseStats]:
    """Inverse of :func:`signature` (modulo dropped non-deterministic
    stats): reconstruct per-phase stats, e.g. to diff a committed
    expectation against a fresh replay."""
    out: List[PhaseStats] = []
    for row in sig:
        stats: Dict[int, Dict] = {}
        for pid, cols in row[4].items():
            per = {}
            for name, col in zip(DETERMINISTIC_COUNTERS, cols):
                if col != 0:
                    per[name] = decode_stat(name, col)
            stats[int(pid)] = per
        out.append(PhaseStats(index=row[0], label=row[1], op=row[2],
                              wall_ns=row[3], stats=stats))
    return out


def result_from_signature(sig: Sequence, mode: str) -> ReplayResult:
    """A diffable :class:`ReplayResult` reconstructed from a committed
    signature (deterministic stats only — exactly the comparable
    surface)."""
    return ReplayResult(
        mode=mode, progress_mode=None, header={}, matches=[],
        divergences=[], phases=signature_phases(sig),
        registry=CounterRegistry(lanes_only=True),
        n_ops=0)


def finding_kinds(res: ReplayResult) -> List[str]:
    """Sorted detector finding kinds over the replay's events (the
    deterministic second half of the comparable surface)."""
    return sorted({f.kind for f in analyses.analyze_all(res.events)})


def encode_shard(res: ReplayResult) -> Dict:
    """One shard's replay as a plain-container payload (cheap to pickle
    across the process pool; also the runner's per-entry task result)."""
    return {
        "mode": res.mode,
        "progress_mode": res.progress_mode,
        "header": res.header,
        "n_ops": res.n_ops,
        "phases": encode_phases(res.phases),
        "pe": res.pe_records,
        "snap": res.raw_snapshot,
    }


def result_from_phases(enc_phases: Sequence, mode: str,
                       progress_mode: Optional[str] = None,
                       header: Optional[Dict] = None,
                       pe_records: Optional[List[Dict]] = None,
                       raw_snap: Optional[Dict] = None,
                       n_ops: int = 0) -> ReplayResult:
    """Reconstruct a :class:`ReplayResult` from encoded phases — enough
    of one for :func:`repro_torch.trace.diff.diff` (which reads ``.phases``
    and ``.mode``) and for the lazy event/finding machinery."""
    return ReplayResult(
        mode=mode, progress_mode=progress_mode, header=header or {},
        matches=[], divergences=[], phases=decode_phases(enc_phases),
        registry=CounterRegistry(lanes_only=True),
        pe_records=pe_records, raw_snap=raw_snap, n_ops=n_ops)
