"""Regenerate the committed golden-trace equivalence pins.

    PYTHONPATH=src python scripts/make_trace_goldens_torch.py

Writes ``tests/goldens/hotpath_goldens.json`` — for every scenario x
engine mode (smoke size, plus full size in the gated ``fifo`` mode): the
sha256 of the deterministic-mode trace file bytes, the detector finding
kinds, and the deterministic queue-metric row — plus one complete golden
trace (``sparse_neighbors`` / fifo / smoke) as a readable JSONL file.

The committed goldens were captured on the PRE-hot-path-overhaul engine
and stay **byte-frozen at schema v2** (``--schema 2``, the default):
the per-op encoding is what pins engine semantics byte-for-byte across
both the PR 4 engine overhaul and the PR 5 trace compaction.
``tests/test_hotpath_equiv.py`` pins the live engine to them.
``--schema 3`` captures the same cells in the compact chunked encoding
(tooling/inspection only — not what the committed goldens use).
Regenerate ONLY after an intentional trace-visible behavior change (new
counters, schema bump, scenario edits) — never to paper over an
equivalence failure.

``--corpus`` instead (re)seeds the committed trace corpus under
``tests/corpus/``: deterministic **v3** traces for every scenario x
engine mode plus ``manifest.json`` with serial-replay expectations (the
regression surface ``scripts/corpus_run.py`` gates). Same regeneration
discipline as the goldens; ``make corpus-baseline`` is the front door.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import workloads  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "tests", "goldens")
GOLDEN_JSON = os.path.join(GOLDEN_DIR, "hotpath_goldens.json")
GOLDEN_TRACE_CELL = ("sparse_neighbors", "fifo", "smoke")
GOLDEN_TRACE_FILE = os.path.join(GOLDEN_DIR,
                                 "sparse_neighbors_fifo_smoke.jsonl")

CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "tests", "corpus")

ENGINE_MODES = ("fifo", "linear", "leaky_umq")
SEED = 0


def seed_corpus_main(root: str, size: str) -> int:
    from repro_torch.corpus import seed_corpus
    store = seed_corpus(root, modes=ENGINE_MODES, size=size, seed=SEED)
    for e in store.entries:
        print(f"{e.id:36s} {e.n_ops:6d} ops {e.n_phases:4d} phases "
              f"{e.sha256[:16]}  {e.expected['findings']}")
    print(f"\n{len(store.entries)} corpus entries written: "
          f"{store.manifest_path}")
    return 0


def capture(scenario: str, mode: str, size: str, scratch: str,
            schema: int) -> dict:
    """One deterministic traced run -> {sha256, findings, row}."""
    path = os.path.join(scratch, f"{scenario}_{mode}_{size}.jsonl")
    run = workloads.run_scenario(scenario, engine_mode=mode, seed=SEED,
                                 size=size, trace_path=path,
                                 wall_clock=False, trace_schema=schema)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return {"path": path, "sha256": digest,
            "findings": run.finding_kinds, "row": run.row()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--schema", type=int, choices=(2, 3), default=2,
                    help="trace schema for the captured goldens "
                         "(committed goldens are frozen at 2)")
    ap.add_argument("--corpus", action="store_true",
                    help="seed tests/corpus/ (v3 traces + manifest "
                         "expectations) instead of the goldens")
    ap.add_argument("--corpus-dir", default=CORPUS_DIR,
                    help="corpus root (default: tests/corpus)")
    ap.add_argument("--size", default="smoke",
                    help="scenario size for --corpus (default: smoke)")
    args = ap.parse_args()
    if args.corpus:
        return seed_corpus_main(args.corpus_dir, args.size)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="goldens_")
    cells = {}
    for name in workloads.names():
        for mode in ENGINE_MODES:
            sizes = ("smoke", "full") if mode == "fifo" else ("smoke",)
            for size in sizes:
                got = capture(name, mode, size, scratch, args.schema)
                cells[f"{name}|{mode}|{size}"] = {
                    "sha256": got["sha256"],
                    "findings": got["findings"],
                    "row": got["row"]}
                if (name, mode, size) == GOLDEN_TRACE_CELL:
                    shutil.copy(got["path"], GOLDEN_TRACE_FILE)
                print(f"{name:22s} {mode:10s} {size:5s} "
                      f"{got['sha256'][:16]}  {got['findings']}")
    payload = {"format": "repro.workloads.hotpath_goldens", "version": 1,
               "seed": SEED, "engine_modes": list(ENGINE_MODES),
               "trace_schema": args.schema,
               "golden_trace": {
                   "cell": "|".join(GOLDEN_TRACE_CELL),
                   "file": os.path.basename(GOLDEN_TRACE_FILE)},
               "cells": cells}
    with open(GOLDEN_JSON, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    shutil.rmtree(scratch, ignore_errors=True)
    print(f"\n{len(cells)} golden cells written: {GOLDEN_JSON}")
    print(f"golden trace written: {GOLDEN_TRACE_FILE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
