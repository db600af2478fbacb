"""Manifest-driven store of committed scenario traces (the corpus).

Layout — a corpus is one directory (the committed one lives at
``tests/corpus/``)::

    tests/corpus/
      manifest.json                      <- the manifest (this module)
      sparse_neighbors__fifo.jsonl       <- deterministic v3 traces
      sparse_neighbors__linear.jsonl
      ...

Every entry pins one recorded trace and what the *current* engine must
reproduce when replaying it:

  * identity — id, scenario, engine mode, size, seed, schema;
  * integrity — sha256 of the trace bytes (traces are recorded with
    ``wall_clock=False``, so the files are byte-deterministic and the
    hash is stable across machines);
  * expectations — the deterministic per-phase/per-rank stat signature
    (:func:`repro_torch.corpus.codec.signature`), detector finding kinds,
    op and phase counts.

:func:`seed_corpus` records the full scenario × engine-mode matrix and
computes expectations by serial replay; ``make corpus-baseline``
regenerates the manifest after an *intentional* engine-behavior change,
exactly like the other committed baselines.

A copy of ``repro.corpus.store``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..trace.replay import Replayer
from .codec import finding_kinds, signature

MANIFEST_NAME = "manifest.json"
CORPUS_FORMAT = "repro.corpus.manifest"
CORPUS_VERSION = 1
ENGINE_MODES = ("fifo", "linear", "leaky_umq")

# Faulted cells the corpus commits alongside the healthy matrix: one
# (scenario, fault kind) pair per replay-reproducible kind, each chosen
# so the kind's dedicated detector verifiably fires at smoke size under
# the healthy fifo engine. ``delay`` is deliberately absent — its
# signal (``fault.delay.deferred``) is counted by the live injector and
# cannot be reconstructed from the recorded op stream, so a delayed
# trace replays clean.
FAULT_CELLS: Tuple[Tuple[str, str], ...] = (
    ("halo3d", "drop"),
    ("ring_allreduce", "duplicate"),
    ("power_law_burst", "reorder"),
    ("amg_coarsen", "rank_leave"),
    ("alltoall_transpose", "rank_join"),
)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclasses.dataclass
class CorpusEntry:
    """One committed trace + its pinned expectations."""

    id: str
    file: str
    scenario: str
    engine_mode: str
    size: str
    seed: int
    schema: int
    sha256: str
    n_ops: int
    n_phases: int
    expected: Dict            # {"phases": <signature>, "findings": [...]}
    fault: Optional[str] = None  # injected fault kind, if any

    def to_json(self) -> Dict:
        out = dataclasses.asdict(self)
        if self.fault is None:
            # healthy entries serialize exactly as before the fault
            # axis existed — keeps their manifest lines byte-stable
            del out["fault"]
        return out

    @classmethod
    def from_json(cls, obj: Dict) -> "CorpusEntry":
        return cls(**{f.name: obj[f.name]
                      for f in dataclasses.fields(cls)
                      if f.name in obj})


class CorpusStore:
    """The manifest plus path resolution over one corpus directory."""

    def __init__(self, root: str,
                 entries: Optional[List[CorpusEntry]] = None):
        self.root = str(root)
        self.entries: List[CorpusEntry] = entries or []

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def path(self, entry: CorpusEntry) -> str:
        return os.path.join(self.root, entry.file)

    def get(self, entry_id: str) -> CorpusEntry:
        for e in self.entries:
            if e.id == entry_id:
                return e
        raise KeyError(f"no corpus entry {entry_id!r}")

    @classmethod
    def load(cls, root: str) -> "CorpusStore":
        store = cls(root)
        with open(store.manifest_path) as f:
            obj = json.load(f)
        if obj.get("format") != CORPUS_FORMAT:
            raise ValueError(
                f"{store.manifest_path}: not a corpus manifest "
                f"(format={obj.get('format')!r})")
        if obj.get("version") != CORPUS_VERSION:
            raise ValueError(
                f"{store.manifest_path}: manifest version "
                f"{obj.get('version')!r}, this reader speaks "
                f"{CORPUS_VERSION}")
        store.entries = [CorpusEntry.from_json(e)
                         for e in obj["entries"]]
        return store

    def save(self) -> None:
        obj = {
            "format": CORPUS_FORMAT,
            "version": CORPUS_VERSION,
            "entries": [e.to_json() for e in self.entries],
        }
        os.makedirs(self.root, exist_ok=True)
        with open(self.manifest_path, "w") as f:
            # compact separators keep the committed expectations small;
            # one entry per line keeps manifest diffs reviewable
            f.write('{"format": %s, "version": %d,\n "entries": [\n'
                    % (json.dumps(CORPUS_FORMAT), CORPUS_VERSION))
            for i, e in enumerate(obj["entries"]):
                tail = "," if i + 1 < len(obj["entries"]) else ""
                f.write("  " + json.dumps(e, separators=(",", ":"),
                                          sort_keys=True) + tail + "\n")
            f.write(" ]}\n")


def expected_for(path: str, mode: Optional[str] = None) -> Dict:
    """Replay a trace serially and package its expectations (the
    ground truth the manifest commits)."""
    res = Replayer(mode=mode, check_matches=False).run(path)
    return {
        "mode": res.mode,
        "n_ops": res.n_ops,
        "n_phases": len(res.phases),
        "expected": {
            "phases": signature(res),
            "findings": finding_kinds(res),
        },
    }


def seed_corpus(root: str,
                scenarios: Optional[Sequence[str]] = None,
                modes: Sequence[str] = ENGINE_MODES,
                size: str = "smoke", seed: int = 0,
                schema: int = 3,
                faults: Optional[Sequence[Tuple[str, str]]] = FAULT_CELLS
                ) -> CorpusStore:
    """Record the scenario × engine-mode matrix as deterministic traces
    under ``root`` and write a manifest with serial-replay expectations.
    ``faults`` appends one fifo-mode cell per (scenario, fault kind)
    pair with that kind's canonical plan injected — the committed
    evidence that a faulted v3 trace replays to the same detector
    verdicts as the live faulted run. Deterministic end to end: same
    engine → byte-identical traces, identical hashes, identical
    manifest."""
    # workloads (the scenario harnesses) only load when seeding — replay,
    # sharding and the runner never pay this import
    from ..workloads.base import names
    from ..workloads.bench import run_scenario

    store = CorpusStore(str(root))
    os.makedirs(store.root, exist_ok=True)
    for sc in (scenarios if scenarios is not None else names()):
        for mode in modes:
            entry_id = f"{sc}__{mode}"
            fname = entry_id + ".jsonl"
            path = os.path.join(store.root, fname)
            run_scenario(sc, engine_mode=mode, seed=seed, size=size,
                         trace_path=path, wall_clock=False,
                         trace_schema=schema)
            exp = expected_for(path)
            store.entries.append(CorpusEntry(
                id=entry_id, file=fname, scenario=sc, engine_mode=mode,
                size=size, seed=seed, schema=schema,
                sha256=file_sha256(path), n_ops=exp["n_ops"],
                n_phases=exp["n_phases"], expected=exp["expected"]))
    for sc, kind in (faults or ()):
        if scenarios is not None and sc not in scenarios:
            continue
        entry_id = f"{sc}__fifo__fault_{kind}"
        fname = entry_id + ".jsonl"
        path = os.path.join(store.root, fname)
        run_scenario(sc, engine_mode="fifo", seed=seed, size=size,
                     trace_path=path, wall_clock=False,
                     trace_schema=schema, fault=kind)
        exp = expected_for(path)
        store.entries.append(CorpusEntry(
            id=entry_id, file=fname, scenario=sc, engine_mode="fifo",
            size=size, seed=seed, schema=schema,
            sha256=file_sha256(path), n_ops=exp["n_ops"],
            n_phases=exp["n_phases"], expected=exp["expected"],
            fault=kind))
    store.save()
    return store


def refresh_expectations(store: CorpusStore) -> CorpusStore:
    """Re-derive every entry's expectations (and hash) from the traces
    already on disk — after an intentional engine-behavior change that
    does not re-record the traces themselves."""
    for entry in store.entries:
        path = store.path(entry)
        exp = expected_for(path)
        entry.sha256 = file_sha256(path)
        entry.n_ops = exp["n_ops"]
        entry.n_phases = exp["n_phases"]
        entry.expected = exp["expected"]
    store.save()
    return store
