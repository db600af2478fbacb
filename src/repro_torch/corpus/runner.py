"""Corpus regression runner: replay every committed trace through the
*current* engine and hold the results against the manifest.

Per entry, three checks — each one a hard failure:

  1. **integrity** — the trace bytes still hash to the committed sha256
     (a silently edited or corrupted corpus must not pass vacuously);
  2. **stats** — the replayed deterministic per-phase/per-rank signature
     equals the committed one bit-for-bit; on mismatch the failure is
     *pointed*: the committed expectation is reconstructed into a
     replay result and diffed against the fresh one via
     ``trace/diff.py`` (``align="label"``), so the report names the
     exact (phase, rank) cells and emits ``long_traversal`` /
     ``umq_flood`` flags when the divergence matches a defect shape;
  3. **findings** — the detector finding kinds match the committed set.

Entries fan out across a :class:`~repro_torch.corpus.parallel.ReplayPool`
(one task per trace; sharded replay stays available per-trace via
``parallel_replay``), so a full corpus run costs about one slowest
trace per pool slot. ``scripts/corpus_run.py`` is the CLI;
``benchmarks/corpus_bench.py`` wires the run into ``verify.sh``.

A copy of ``repro.corpus.runner``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

from ..core.comparison import ProfileReport, ReportRow
from ..trace.diff import diff
from .codec import (DETERMINISTIC_COUNTERS, finding_kinds,
                    result_from_phases, result_from_signature, signature)
from .parallel import InlinePool, ReplayPool, default_jobs, shard_worker
from .store import CorpusEntry, CorpusStore, file_sha256

# signature stat everything deterministic hangs off for the report rows:
# total PRQ entries traversed is the paper's cost currency
DEPTH_COL = DETERMINISTIC_COUNTERS.index("match.prq.traversal_depth")


def _depth_total(sig: Sequence) -> float:
    total = 0.0
    for row in sig:
        for cols in row[4].values():
            col = cols[DEPTH_COL]
            if col:
                total += col[1]
    return total


def _entry_task(task):
    """One pool task: full (unsharded) replay of one corpus trace,
    reduced in the worker to the comparable surface — nothing heavier
    than the signature crosses the process boundary."""
    path, mode, progress_mode = task
    enc = shard_worker((path, mode, progress_mode, None, None))
    res = result_from_phases(
        enc["phases"], mode=enc["mode"],
        progress_mode=enc["progress_mode"], pe_records=enc["pe"],
        raw_snap=enc["snap"], n_ops=enc["n_ops"])
    return {
        "mode": enc["mode"],
        "n_ops": enc["n_ops"],
        "n_phases": len(enc["phases"]),
        "phases": signature(res),
        "findings": finding_kinds(res),
    }


@dataclasses.dataclass
class EntryResult:
    """One corpus entry's verdict."""

    id: str
    ok: bool
    n_ops: int
    mode: str
    failures: List[str] = dataclasses.field(default_factory=list)
    flags: List[str] = dataclasses.field(default_factory=list)
    diff_text: Optional[str] = None

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CorpusRunResult:
    root: str
    results: List[EntryResult]
    report: ProfileReport

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def failures(self) -> List[str]:
        return [f"{r.id}: {msg}" for r in self.results
                for msg in r.failures]

    def to_json(self) -> Dict:
        return {
            "root": self.root,
            "ok": self.ok,
            "entries": [r.to_json() for r in self.results],
        }

    def render(self) -> str:
        lines = [f"corpus {self.root}: "
                 f"{sum(r.ok for r in self.results)}/"
                 f"{len(self.results)} entries clean"]
        for r in self.results:
            mark = "ok  " if r.ok else "FAIL"
            lines.append(f"  [{mark}] {r.id:34s} {r.n_ops:6d} ops "
                         f"({r.mode})")
            for msg in r.failures:
                lines.append(f"         - {msg}")
            if r.diff_text:
                lines.extend("         | " + ln
                             for ln in r.diff_text.splitlines())
        return "\n".join(lines)


def run_corpus(root_or_store: Union[str, CorpusStore],
               jobs: Optional[int] = None,
               pool: Optional[Union[ReplayPool, InlinePool]] = None,
               entries: Optional[Sequence[str]] = None,
               mode_override: Optional[str] = None,
               diff_limit: int = 6) -> CorpusRunResult:
    """Replay the corpus against the current engine and gate it.

    ``mode_override`` replays every entry under a different engine mode
    — the what-if / divergence-injection hook (a healthy engine under
    its own mode diffs clean; an override like ``"linear"`` must fail
    with pointed ``long_traversal`` diffs, which the tests assert)."""
    store = (root_or_store if isinstance(root_or_store, CorpusStore)
             else CorpusStore.load(str(root_or_store)))
    selected = [e for e in store.entries
                if entries is None or e.id in set(entries)]
    if entries is not None and len(selected) < len(set(entries)):
        known = {e.id for e in selected}
        missing = sorted(set(entries) - known)
        raise KeyError(f"unknown corpus entries: {missing}")

    results: List[EntryResult] = []
    rows: List[ReportRow] = []
    findings = []

    runnable: List[CorpusEntry] = []
    tasks = []
    pending: List[EntryResult] = []
    for entry in selected:
        res = EntryResult(id=entry.id, ok=True, n_ops=entry.n_ops,
                          mode=mode_override or entry.engine_mode)
        path = store.path(entry)
        try:
            got_sha = file_sha256(path)
        except OSError as exc:
            res.ok = False
            res.failures.append(f"trace unreadable: {exc}")
            results.append(res)
            continue
        if got_sha != entry.sha256:
            res.ok = False
            res.failures.append(
                f"sha256 mismatch: manifest {entry.sha256[:12]}…, "
                f"file {got_sha[:12]}… (trace bytes changed without "
                f"`make corpus-baseline`)")
            results.append(res)
            continue
        tasks.append((path, mode_override, None))
        pending.append(res)
        runnable.append(entry)

    if tasks:
        if pool is not None:
            outs = pool.map(_entry_task, tasks)
        elif (jobs or default_jobs()) > 1 and len(tasks) > 1:
            with ReplayPool(jobs=min(jobs or default_jobs(),
                                     len(tasks))) as p:
                outs = p.map(_entry_task, tasks)
        else:
            outs = [_entry_task(t) for t in tasks]
    else:
        outs = []

    for entry, res, out in zip(runnable, pending, outs):
        exp = entry.expected
        res.n_ops = out["n_ops"]
        if out["n_ops"] != entry.n_ops:
            res.ok = False
            res.failures.append(
                f"op count {out['n_ops']} != recorded {entry.n_ops}")
        if out["n_phases"] != entry.n_phases:
            res.ok = False
            res.failures.append(
                f"phase count {out['n_phases']} != recorded "
                f"{entry.n_phases}")
        if out["findings"] != exp["findings"]:
            res.ok = False
            res.failures.append(
                f"finding kinds {out['findings']} != committed "
                f"{exp['findings']}")
        if out["phases"] != exp["phases"]:
            res.ok = False
            n_cells = sum(1 for a, b in zip(exp["phases"], out["phases"])
                          if a != b)
            res.failures.append(
                f"stat signature diverges in {n_cells} phase(s)")
            expected_res = result_from_signature(
                exp["phases"], mode=entry.engine_mode)
            got_res = result_from_signature(out["phases"],
                                            mode=out["mode"])
            d = diff(expected_res, got_res, align="label")
            res.diff_text = d.report(limit=diff_limit)
            res.flags = sorted({f.kind for f in d.flags()})
            findings.extend(d.flags())
        rows.append(ReportRow(
            path=entry.id,
            baseline=_depth_total(exp["phases"]),
            candidate=_depth_total(out["phases"]),
            unit="queue-entries"))
        results.append(res)

    report = ProfileReport(
        kind="corpus", baseline_name="committed expectations",
        candidate_name=(f"current engine ({mode_override})"
                        if mode_override else "current engine"),
        rows=rows, findings=findings)
    return CorpusRunResult(root=store.root, results=results,
                           report=report)
